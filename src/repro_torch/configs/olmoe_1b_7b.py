"""olmoe-1b-7b [moe]: 16L, d=2048, 16H (kv=16), expert d_ff=1024,
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    qk_norm=True,
    num_experts=64, experts_per_token=8,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=64,
                          vocab_size=256, num_experts=8, experts_per_token=2,
                          dtype="float32", remat=False)
