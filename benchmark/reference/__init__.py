"""The benchmark's plain reference: a frozen copy of madarch_tpu_torch's
plain path (scene building, packing, the plain versions of the four march
kernels, the shade, the probes and the frame pipeline), with its imports
pointed here.  It imports nothing of the port: the port may change under
later benchmarks, this copy does not.  Every march runs its plain PyTorch
version, on the CPU or on the card."""
