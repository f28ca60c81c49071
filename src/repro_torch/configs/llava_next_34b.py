"""llava-next-34b [vlm]: 60L, d=7168, 56H (GQA kv=8), d_ff=20480,
vocab=64000.  Anyres vision frontend is a STUB: input_specs supplies
patch embeddings (B, 576, 7168).  [hf:llava-hf family; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    rope_theta=5e6, vision_patches=576,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, d_ff=128,
                          vocab_size=256, vision_patches=8,
                          dtype="float32", remat=False)
