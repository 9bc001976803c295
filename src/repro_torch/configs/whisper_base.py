"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified] (copy of ``repro.configs.whisper_base``).

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.  The
convolutional audio frontend is a stub: 1500 precomputed frame embeddings
are the encoder's input.  Deviation from Whisper, as the reference's: RoPE in the
decoder instead of learned absolute positions, and no positions at all in
the encoder.
"""
from repro_torch.configs.base import EncoderSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    encoder=EncoderSpec(n_layers=6, n_heads=8, n_kv_heads=8, d_ff=2048,
                        source_len=1500),
    frontend="audio_stub",
))
