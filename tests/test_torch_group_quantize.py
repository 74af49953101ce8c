"""``group_quantize``'s redesigned kernel, its arithmetic and schedule on the
CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py, under the
``cuda`` marker).  Here ``quantize.emulate_vector`` replays its vector
route block by block in plain torch (the [G, 128] tiles of
``quantize.schedule``, each warp's row slice reducing its own absmax, the
slices' maxima meeting, codes packed from row pairs) and must equal the
plain version and the JAX reference (its Pallas quantizer in interpret
mode) bit for bit: at the main path's seven shapes at a narrow width, at
odd shapes on the vector route, with and without packing, and with every
output element written by exactly one block.  ``route`` is a function of
the shape alone, and the grouped entry equals one call per matrix.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref

# qwen2-0.5b's agent matmuls cut to d_model 256, d_ff 512 (K and N on the
# reference's 128 grid, so it takes its Pallas kernel): wq, wk, wv, wo,
# gate, up, down
NARROW = [(256, 256), (256, 128), (256, 128), (256, 256), (256, 512),
          (256, 512), (512, 256)]
# (k, n, g) on the vector route off the main path: a ragged column tile,
# each register-slot count G / 8 = 2..32, a single group
ODD = [(640, 132, 64), (64, 256, 16), (96, 36, 32), (512, 64, 256),
       (256, 1028, 128), (48, 20, 48)]


def _normal(seed, shape, zero_group=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    w[:zero_group] = 0.0
    return w


def _plain(w, g, bits, pack):
    codes, scales = tref.group_quantize_ref(w, g, bits)
    return (tref.pack_int4_ref(codes) if pack and bits <= 4 else codes,
            scales)


@pytest.fixture(autouse=True)
def _no_launches():
    tk.reset_launch_counts()
    yield
    assert tk.launch_counts()["group_quantize"] == 0      # CPU: plain


@pytest.mark.parametrize("bits,pack", [(8, False), (4, False), (4, True),
                                       (3, True)])
def test_emulated_schedule_equals_plain_and_reference(bits, pack):
    """One grouped launch over a configure's matrices (two agent layers at
    the narrow width) equals the plain version and the reference."""
    mats = [_normal(i, shape, zero_group=128 if i == 0 else 0)
            for i, shape in enumerate(NARROW * 2)]
    ws = [torch.from_numpy(w) for w in mats]
    got = tq.emulate_vector(ws, [128] * len(ws), [bits] * len(ws),
                            pack=pack)
    for w, wj, (codes, scales) in zip(ws, mats, got):
        want = _plain(w, 128, bits, pack)
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
        cj, sj = jops.group_quantize(jnp.asarray(wj), group_size=128,
                                     bits=bits)
        if pack and bits <= 4:
            cj = jref.pack_int4_ref(cj)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(sj))


@pytest.mark.parametrize("k,n,g", ODD)
@pytest.mark.parametrize("bits,pack", [(8, False), (4, True)])
def test_emulated_schedule_on_odd_shapes(k, n, g, bits, pack):
    w = torch.from_numpy(_normal(k + n + g, (k, n), zero_group=g))
    assert tq.route(k, n, g) == "vector"
    (codes, scales), = tq.emulate_vector([w], [g], [bits], pack=pack)
    want = _plain(w, g, bits, pack)
    assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])


def test_schedule_covers_every_tile_once():
    shapes = [(256, 128, 128), (640, 132, 64), (512, 64, 256)]
    firsts, total = tq.schedule(shapes)
    assert firsts == [0, 2, 2 + 10 * 2]
    assert total == 2 + 20 + 2
    assert tq.schedule([]) == ([], 0)


@pytest.mark.parametrize("k,n,g,way", [
    (896, 896, 128, "vector"), (896, 128, 128, "vector"),
    (896, 4864, 128, "vector"), (4864, 896, 128, "vector"),
    (640, 132, 64, "vector"), (64, 256, 16, "vector"),
    (512, 64, 256, "vector"),
    (192, 128, 1, "simt"),        # per-element groups
    (256, 127, 64, "simt"),       # N not a multiple of 4
    (96, 33, 96, "simt"),
    (96, 128, 96, "vector"),      # one group of 96 = 6 x 16 rows
    (1024, 128, 512, "simt"),     # G past MAX_GROUP
    (40, 128, 8, "simt"),         # G not a multiple of 16
])
def test_route_is_a_function_of_the_shape(k, n, g, way):
    assert tq.route(k, n, g) == way
    assert tq.route(k, n, g) == tq.route(k, n, g)   # no hidden state


def test_emulation_refuses_the_simt_route():
    with pytest.raises(ValueError, match="vector route"):
        tq.emulate_vector([torch.zeros(192, 128)], [1], [8])


@pytest.mark.parametrize("pack", [False, True])
def test_grouped_entry_equals_one_call_each(pack):
    """group_quantize_many over mixed shapes, groups, bits and routes
    equals group_quantize per matrix (and ops.quantize_linears equals
    ops.quantize_linear, packing and the reference's group layout
    included)."""
    shapes = [(256, 128, 128, 8), (640, 132, 64, 4), (192, 128, 1, 4),
              (130, 7, 1, 8), (512, 256, 128, 3)]
    ws = [torch.from_numpy(_normal(i, (k, n))) for i, (k, n, _, _)
          in enumerate(shapes)]
    got = tq.group_quantize_many(ws, [s[2] for s in shapes],
                                 [s[3] for s in shapes], pack=pack)
    for w, (k, n, g, b), (codes, scales) in zip(ws, shapes, got):
        one = tq.group_quantize(w, group_size=g, bits=b, pack=pack)
        assert torch.equal(codes, one[0]) and torch.equal(scales, one[1])
    lins = tops.quantize_linears(ws, [s[3] for s in shapes])
    for w, (_, _, _, b), lin in zip(ws, shapes, lins):
        one = tops.quantize_linear(w, bits=b)
        assert torch.equal(lin.codes, one.codes)
        assert torch.equal(lin.scales, one.scales)
        assert lin.bits == one.bits == b and lin.k == w.shape[0]


def test_grouped_entry_validates():
    w = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="differ in length"):
        tq.group_quantize_many([w], [128, 128], [8])
    with pytest.raises(ValueError, match="does not divide"):
        tq.group_quantize_many([w], [100], [8])
    with pytest.raises(ValueError, match="1..8 bits"):
        tq.group_quantize_many([w], [128], [9])
    assert tq.group_quantize_many([], [], []) == []
