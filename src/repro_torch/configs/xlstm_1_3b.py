"""xlstm-1.3b [ssm]: 48 blocks, d=2048, 4 heads (head_dim 512), vocab=50304;
mLSTM blocks with an sLSTM block every 8th (7:1 ratio).
Attention-free: runs the long_500k cell.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_1_3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=512,
    rope=False, slstm_every=8,
)

def smoke_config():
    return CONFIG.replace(num_layers=4, d_model=64, num_heads=2,
                          num_kv_heads=2, head_dim=32, vocab_size=256,
                          slstm_every=3, ssm_chunk=8,
                          dtype="float32", remat=False)
