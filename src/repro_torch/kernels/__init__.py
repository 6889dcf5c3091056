"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: `fc_gemv` (FC-PIM) and `decode_attention` (Attn-PIM)."""
