"""chatglm3-6b [dense]: 28L, d=4096, 32H (GQA kv=2), d_ff=13696,
vocab=65024.  RoPE-2d realized as partial (half-dim) rotary.
[arXiv:2406.12793; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3_6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    partial_rotary=0.5, qkv_bias=True,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32", remat=False)
