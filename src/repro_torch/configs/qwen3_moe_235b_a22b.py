"""qwen3-moe-235b-a22b [moe]: 94L, d=4096, 64H (GQA kv=4, head_dim 128),
expert d_ff=1536, vocab=151936, MoE 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    num_experts=128, experts_per_token=8,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=96,
                          vocab_size=256, num_experts=8, experts_per_token=2,
                          dtype="float32", remat=False)
