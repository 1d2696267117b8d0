"""Probes of the card (JAX counterparts: scripts/probe_floor.py,
scripts/probe_chain.py and scripts/probe_precision.py).

    python -m ecg_denoise_tpu_torch.probes.floor      # null launch, dma floor, B1/B5 by batch
    python -m ecg_denoise_tpu_torch.probes.chain      # K calls from Python vs one CUDA graph
    python -m ecg_denoise_tpu_torch.probes.precision  # how each arithmetic path rounds
    python -m ecg_denoise_tpu_torch.probes.sass_mix   # B3's D = 4 loop, instructions a (row, key)

Each but `sass_mix` (which reads the compiler's output: nvcc, no card)
measures the card and raises without one; none falls back to the CPU
or skips a case that fails. The launch probes' null call is
`kernels.null_copy`; the precision probe's kernels are `kernels.precision`.
"""
