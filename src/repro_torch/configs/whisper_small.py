"""whisper-small [audio]: enc-dec, 12L/12L, d=768, 12H, d_ff=3072,
vocab=51865.  Conv frontend is a STUB: input_specs supplies precomputed
frame embeddings (B, 1500, 768).  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper_small", family="encdec",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    rope=False, norm="layernorm", act="gelu",
    encoder_layers=12, encoder_seq=1500,
)

def smoke_config():
    return CONFIG.replace(num_layers=2, encoder_layers=2, d_model=64,
                          num_heads=4, num_kv_heads=4, head_dim=16,
                          d_ff=128, vocab_size=256, encoder_seq=16,
                          dtype="float32", remat=False)
