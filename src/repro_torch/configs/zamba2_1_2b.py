"""zamba2-1.2b [hybrid]: 38 Mamba2 layers, d=2048, ssm_state=64, with ONE
shared attention+MLP block (32H, d_ff=8192) applied every 6 layers
(weights shared, caches per site).  Runs long_500k.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1_2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, shared_attn_every=6,
)

def smoke_config():
    return CONFIG.replace(num_layers=5, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, ssm_state=16, shared_attn_every=2,
                          ssm_chunk=8, dtype="float32", remat=False)
