"""smollm-360m [dense]: 32L, d=960, 15H (GQA kv=5), d_ff=2560,
vocab=49152, llama-arch small, tied embeddings.
[hf:HuggingFaceTB/SmolLM family; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm_360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=60, num_heads=3,
                          num_kv_heads=1, head_dim=20, d_ff=128,
                          vocab_size=256, dtype="float32", remat=False)
