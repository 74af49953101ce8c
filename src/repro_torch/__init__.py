"""PyTorch/CUDA port of the quantized co-inference system.

A second package beside the JAX reference ``repro``: same ``PYTHONPATH=src``
import root, no install step, and no import of ``jax`` or of any ``repro``
module.  Module names mirror the reference (``configs``, ``kernels``,
``core``, ``models``, ``runtime``, ``launch``, ``data``) so each file's
counterpart is easy to find; ``bridge`` carries the reference's parameter
pytree across as numpy arrays.

Entry points run on the CUDA card unless the caller asks for the CPU
(:func:`repro_torch.device.resolve_device`).  The three kernels of the
quantized forward (``group_quantize``, ``qmm``, ``qmm_int4``) are CUDA C++
under ``kernels/csrc/``; on a CPU tensor each wrapper runs its plain torch
version instead.
"""
