"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: `fc_gemv` (FC-PIM), `decode_attention` and
`paged_decode_attention` (Attn-PIM over a dense slab or over pages), and
`ssd_scan` (the Mamba2 SSD chunk scan of every SSM prefill); `ops` puts
FC-PIM and ``torch.matmul`` behind one call (`fc_forward`)."""
