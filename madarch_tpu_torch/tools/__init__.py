"""The port's measuring probes (port of the root tools/ probes), each run as
``python -m madarch_tpu_torch.tools.<name>``: perf_probe, geom_probe,
train_probe, diag_golden, and trace_probe (the port's own recorder over a
closed loop of frames, and its cost).  They run on the CUDA card unless ``--device``
names another device.

Not ported, by design: tools/ab_cull.py (it A/Bs the TPU kernels' culling
knobs, which the port does not have) and tools/make_goldens.py (the goldens
come from the JAX package on the CPU; the port is held to them and never
writes them)."""
