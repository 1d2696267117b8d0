"""Launch-floor probes on the card (JAX counterparts: scripts/probe_floor.py
and scripts/probe_chain.py).

    python -m ecg_denoise_tpu_torch.probes.floor   # null launch, dma floor, B1/B5 by batch
    python -m ecg_denoise_tpu_torch.probes.chain   # K calls from Python vs one CUDA graph

Both measure the card and raise without one; neither falls back to the CPU
or skips a case that fails. Their null call is `kernels.null_copy`.
"""
