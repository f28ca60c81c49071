"""glm4-9b [dense]: 40L, d=4096, 32H (GQA kv=2), d_ff=13696,
vocab=151552, partial rotary.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4_9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552, head_dim=128,
    partial_rotary=0.5,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, dtype="float32", remat=False)
