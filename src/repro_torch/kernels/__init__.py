"""Kernels of the PyTorch port: CUDA C++ sources in ``csrc/``, their
wrappers, the plain PyTorch versions (:mod:`repro_torch.kernels.ref`) and
the backend dispatch (:mod:`repro_torch.kernels.ops`).  Importing this
package builds nothing; the CUDA libraries are built at first launch."""
