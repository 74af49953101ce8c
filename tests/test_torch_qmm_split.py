"""The arithmetic of the tensor-core qmm kernel, checked on the CPU.

The kernel (``csrc/qmm.cu``, route ``"wgmma"``) multiplies exact bf16
codes by a three-piece bf16 split of the f32 activation and promotes each
group's f32 partial by its scale.  What makes that f32-accurate is checked
here in plain torch: the split is exact, codes and piece-code products are
exact, and the kernel's order of arithmetic (``ref.qmm_split_emulation``)
agrees with the plain version ``ref.qmm_ref`` within 1e-5 relative to the
output's scale.  The route each shape takes and the split-K count are
pure functions of the shape, also checked here; the kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import importlib
import inspect

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import ref as tref

# the module (the package's name ``qmm`` is the wrapper function)
tqmm = importlib.import_module("repro_torch.kernels.qmm")

MAIN_PATH = [(k, n) for k in (896, 4864) for n in (128, 896, 4864)]


def _values(kind, seed=0, size=20000):
    rng = np.random.default_rng(seed)
    if kind == "wide":          # 1e-30 .. 1e30, both signs
        mag = 10.0 ** rng.uniform(-30, 30, size)
        x = np.sign(rng.standard_normal(size)) * mag
    elif kind == "activations":  # the main path's scale: normed, O(1..100)
        x = rng.standard_normal(size) * 10.0 ** rng.uniform(-2, 2, size)
    else:                       # random f32 bit patterns of normal numbers
        bits = rng.integers(0, 2 ** 32, size, dtype=np.uint64)
        x = bits.astype(np.uint32).view(np.float32).astype(np.float64)
        x = x[np.isfinite(x) & (np.abs(x) >= 1e-30) & (np.abs(x) <= 1e30)]
    x = x.astype(np.float32)
    x[:50] = 0.0
    x[50:100] = -np.abs(x[50:100])
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["wide", "activations", "bits"])
def test_split_sums_back_exactly(kind):
    x = _values(kind)
    hi, mid, lo = tref.split_bf16(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    # and in f32, the order the tensor cores see it summed
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)


@pytest.mark.parametrize("bits", [8, 4])
def test_codes_exact_in_bf16(bits):
    if bits == 8:
        codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    else:
        every_byte = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        codes = tref.unpack_int4_ref(every_byte.view(torch.int8)[:, None])
        assert int(codes.min()) == -8 and int(codes.max()) == 7
    as_bf16 = codes.to(torch.bfloat16)
    assert torch.equal(as_bf16.to(torch.int32), codes.to(torch.int32))


def test_piece_times_code_exact_in_f32():
    x = _values("wide", seed=1, size=4000)
    codes = torch.arange(-127, 128, dtype=torch.float32)
    for piece in tref.split_bf16(x):
        p = piece.float()[:, None]
        assert torch.equal((p * codes).double(),
                           p.double() * codes.double())


@pytest.mark.parametrize("k", [896, 4864])
@pytest.mark.parametrize("bits", [8, 4])
def test_emulation_matches_plain(k, bits):
    rng = np.random.default_rng(k + bits)
    n, m = 96, 3
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5)
                         .astype(np.float32))
    codes, scales = tref.group_quantize_ref(w, 128, bits)
    got = tref.qmm_split_emulation(x, codes, scales)
    if bits == 4:   # the int4 kernel unpacks to the same codes
        codes = tref.unpack_int4_ref(tref.pack_int4_ref(codes))
    want = tref.qmm_ref(x, codes, scales)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("k,n", MAIN_PATH)
def test_main_path_takes_the_tensor_cores(k, n):
    assert tqmm.route(k, n, 128) == "wgmma"


@pytest.mark.parametrize("k,n,g", [
    (192, 128, 1), (896, 4864, 1),            # per-element groups
    (256, 127, 64), (896, 127, 128),          # rows off 16 bytes
    (200, 64, 1), (200, 64, 8), (200, 64, 40), (200, 64, 200),
    (96, 64, 24), (512, 129, 256),
])
def test_other_shapes_take_simt(k, n, g):
    assert tqmm.route(k, n, g) == "simt"


def test_split_count_is_independent_of_m():
    assert "m" not in inspect.signature(tqmm.splits).parameters
    for k, n in MAIN_PATH:
        s = tqmm.splits(k, n, 128, 132)
        assert 1 <= s <= k // 128
        assert k // s >= tqmm.MIN_SPLIT_K or s == 1
    # the shapes whose N tiles alone leave SMs idle split K
    assert tqmm.splits(4864, 896, 128, 132) > 1
    assert tqmm.splits(896, 128, 128, 132) > 1
    assert tqmm.splits(96, 64, 32, 132) == 1


def test_cpu_calls_count_no_route():
    tk.reset_launch_counts()
    x = torch.zeros(2, 256)
    codes, scales = tref.group_quantize_ref(torch.ones(256, 64), 128)
    tk.qmm(x, codes, scales)
    tk.qmm_int4(x, tref.pack_int4_ref(codes), scales)
    assert tk.qmm.route_launches == {"wgmma": 0, "simt": 0}
    assert tk.qmm_int4.route_launches == {"wgmma": 0, "simt": 0}
    assert tk.qmm.launches == tk.qmm_int4.launches == 0
