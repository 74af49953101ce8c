"""Hand-written CUDA kernels of the port, each beside its plain version.

=================  ====================  ==================================
wrapper            CUDA source           TPU kernel it replaces
=================  ====================  ==================================
``group_quantize`` csrc/group_quantize   repro/kernels/quantize.py
                   (one launch per
                   configure; SIMT
                   route)
``qmm``            csrc/qmm (bf16 wgmma  repro/kernels/qmm.py ``qmm``
                   on a 3-piece split
                   of x; SIMT route)
``qmm_int4``       csrc/qmm (the same)   repro/kernels/qmm.py ``qmm_int4``
``quantized_       csrc/decode_attn      repro/kernels/decode_attn.py
decode_attention`` (split over the       ``quantized_decode_attention``
                   cache, fixed-order
                   combine)
``flash_attention  csrc/flash_attn       repro/kernels/flash.py
_fwd``             (three-pass TF32      ``flash_attention_fwd``
                   wgmma)
``row_gemm``       csrc/row_gemm (rows   none: the port's own, for the
                   independent of M)     decode step's projections
``tc_gemm``        csrc/tc_gemm (three-  none: the port's own, for the
                   pass TF32 wgmma, rows split forward's products
                   independent of M)
=================  ====================  ==================================

Each wrapper launches its kernel for a CUDA tensor and runs its plain
torch version (``ref.py``) for a CPU tensor; it counts its kernel launches
in a ``launches`` attribute (``group_quantize``, ``qmm`` and ``qmm_int4``
also per route, in ``route_launches``).  A launch recorded into a CUDA
graph counts in the capture's record instead (``build.recording``), since
it runs at each replay.  ``flash.flash_attention`` differentiates
``flash_attention_fwd`` (backward through the plain oracle, as in the
reference).
"""

from __future__ import annotations

from .decode_attn import quantized_decode_attention
from .flash import flash_attention_fwd
from .qmm import qmm, qmm_int4, reset_route_launches
from .quantize import group_quantize
from .row_gemm import row_gemm
from .tc_gemm import tc_gemm

KERNELS = {"group_quantize": group_quantize, "qmm": qmm,
           "qmm_int4": qmm_int4,
           "quantized_decode_attention": quantized_decode_attention,
           "flash_attention_fwd": flash_attention_fwd,
           "row_gemm": row_gemm, "tc_gemm": tc_gemm}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    reset_route_launches()
    group_quantize.route_launches = dict.fromkeys(
        group_quantize.route_launches, 0)
