"""The port's model: layers, the FC hook, the MoE layer, the Mamba2 block,
the step functions of the dense, MoE, VLM, SSM and hybrid families over a
dense KV slab or (the KV-only families) a paged KV pool, and the training
forward of every family, the audio encoder included."""
from repro_torch.models.layers import attn_impl, current_attn_impl
from repro_torch.models.linear import current_fc_variant, fc_variant
from repro_torch.models.model import (chunk_logits, decode_step,
                                      forward_train, init_cache,
                                      init_paged_cache, init_params,
                                      mixed_step, model_spec, prefill,
                                      prefill_chunk, prefill_to_pages,
                                      prefill_to_slots, rewind_ssm,
                                      ssm_step_buffers)
from repro_torch.models.ssm import current_ssd_impl, ssd_impl
from repro_torch.models.weights import (params_from_jax, shard_params,
                                        unshard_params)

__all__ = ["attn_impl", "chunk_logits", "current_attn_impl",
           "current_fc_variant", "current_ssd_impl", "decode_step",
           "fc_variant", "forward_train", "init_cache", "init_paged_cache",
           "init_params", "mixed_step", "model_spec", "params_from_jax",
           "prefill", "prefill_chunk", "prefill_to_pages", "prefill_to_slots",
           "rewind_ssm", "shard_params", "ssd_impl", "ssm_step_buffers",
           "unshard_params"]
