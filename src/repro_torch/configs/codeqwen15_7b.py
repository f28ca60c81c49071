"""codeqwen1.5-7b [dense]: 32L, d=4096, 32H (MHA kv=32), d_ff=13440,
vocab=92416, qwen1.5-arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen15_7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32", remat=False)
