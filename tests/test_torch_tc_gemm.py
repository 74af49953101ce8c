"""The split forward's row-independent tensor-core GEMM
(``kernels/tc_gemm.py``, ``csrc/tc_gemm.cu``) on the CPU, and the
co-inference split forward that runs every float32 product on it.

* ``route`` takes every split-forward product of every registered decoder
  config (q, k, v, o, the dense MLP's, the head, tied or not) at any M up
  to 2,048, a function of (K, N) alone; the fake version passes those
  shapes on ``meta`` and refuses what the kernel refuses (K % 4, a
  row-major N % 4, unaligned operands, other dtypes, mixed devices); a
  tensor off the CPU never reaches ``torch.matmul``.
* ``opcheck`` of the op, its fake shapes and its FLOPs (2MNK).
* qwen2-smoke's split forward on ``meta`` (the card's program) dispatches
  no ``aten.mm``/``addmm``/``bmm``: 7 ``tc_gemm`` calls a layer and one
  for the head on the fake path; the kernel path 7 a server layer and
  the head, its agent on ``qmm``.
* On the CPU the forward is bitwise the one through ``matmul_group``, and
  the engine stays within 1e-4 of the JAX reference engine
  (``tests/test_torch_serve.py``'s comparison) with its products on the
  op.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import _PORTED, get_config, get_smoke
from repro_torch.kernels import ref
from repro_torch.launch import opcount as oc
from repro_torch.models import layers as L
from repro_torch.models.lm import DecoderLM
from repro_torch.models.registry import build_model
from repro_torch.runtime import fastpath as fp
from test_torch_serve import CASES, TOL, engines  # noqa: F401

tg = importlib.import_module("repro_torch.kernels.tc_gemm")

MATMULS = ("aten.mm", "aten.addmm", "aten.bmm")
DECODERS = [a for a in sorted(_PORTED) if get_config(a) is not None
            and isinstance(build_model(get_smoke(a)), DecoderLM)]


def split_products(cfg):
    """(K, N, layout) of every product of the split forward of ``cfg``:
    the attention's, the dense MLP's (an MoE's experts run as torch
    products) and the head's."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = [(d, q, "kn"), (d, kv, "kn"), (q, d, "kn")]
    if not cfg.n_experts:
        out += [(d, cfg.d_ff, "kn"), (cfg.d_ff, d, "kn")]
    out.append((d, cfg.vocab_size, "nk" if cfg.tie_embeddings else "kn"))
    return out


def _w(k, n, layout, device="meta"):
    if layout == "kn":
        return torch.empty((k, n), device=device)
    return torch.empty((n, k), device=device).T


@pytest.mark.parametrize("arch", DECODERS)
def test_route_covers_every_split_forward_product(arch):
    """Every product of the published config: a route from (K, N) alone
    (column tile 64 or 128, K in at most 8 parts of whole 32-deep tiles,
    none empty), and the fake version takes it on ``meta`` at M = 1, 17,
    506 and 2,048 with the output's shape."""
    cfg = get_config(arch)
    for k, n, layout in split_products(cfg):
        r = tg.route(k, n)
        assert r.block_n in (64, 128) and 1 <= r.splits <= tg.MAX_SPLITS
        assert r.chunk % tg.TILE_K == 0
        assert (r.splits - 1) * r.chunk < k <= r.splits * r.chunk
        w = _w(k, n, layout)
        for m in (1, 17, 506, 2048):
            y = tg.tc_gemm(torch.empty((m, k), device="meta"), w)
            assert y.shape == (m, n) and y.device.type == "meta"


def test_cpu_is_torch_matmul_and_opcheck():
    """On CPU tensors the op is ``torch.matmul`` bitwise, for both
    layouts; ``opcheck`` passes."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((17, 64)).astype(np.float32))
    for w in (torch.from_numpy(rng.standard_normal((64, 40)).astype(
                  np.float32)),
              torch.from_numpy(rng.standard_normal((40, 64)).astype(
                  np.float32)).T):
        assert torch.equal(tg.tc_gemm(x, w), torch.matmul(x, w))
        assert torch.equal(ref.tc_gemm_ref(x, w), torch.matmul(x, w))
        torch.library.opcheck(tg.tc_gemm_op, (x, w))


def test_fake_shape_and_flops():
    """The accountant bills one call at 2MNK FLOPs and its operands'
    bytes, on ``meta``."""
    x = torch.empty((300, 896), device="meta")
    w = _w(896, 4864, "kn")
    c = oc.analyze(lambda: tg.tc_gemm(x, w))
    assert c.flops == 2 * 300 * 896 * 4864
    assert c.kernel_calls == {"tc_gemm": 1}
    assert c.op_bytes["repro_torch.tc_gemm"] == 4 * (300 * 896 + 896 * 4864
                                                     + 300 * 4864)


@pytest.mark.parametrize("what", ["k % 4", "row-major n % 4", "unaligned x",
                                  "unaligned w", "bfloat16",
                                  "mixed devices", "shapes"])
def test_refuses_what_the_kernel_cannot_take(what):
    """Off the CPU (``meta``: the card's path) a shape or operand the
    kernel cannot take raises, as on the card."""
    meta = dict(device="meta")
    x, w = torch.empty((5, 64), **meta), torch.empty((64, 32), **meta)
    bad = {"k % 4": (torch.empty((5, 30), **meta),
                     torch.empty((30, 32), **meta)),
           "row-major n % 4": (x, torch.empty((64, 30), **meta)),
           "unaligned x": (torch.empty(5 * 64 + 1, **meta)[1:].view(5, 64),
                           w),
           "unaligned w": (x, torch.empty(64 * 32 + 1, **meta)[1:].view(
               64, 32)),
           "bfloat16": (x.bfloat16(), w.bfloat16()),
           "mixed devices": (torch.empty((5, 64)), w),
           "shapes": (x, torch.empty((63, 32), **meta))}[what]
    with pytest.raises(ValueError):
        tg.tc_gemm(*bad)


def test_a_card_tensor_never_reaches_torch_matmul(monkeypatch):
    """The op's implementation for a tensor off the CPU launches (here a
    stand-in for the launch) and never calls ``torch.matmul`` or the
    plain version."""
    calls = []

    def refuse(*a, **k):
        raise AssertionError("torch.matmul on the card's path")
    monkeypatch.setattr(torch, "matmul", refuse)
    monkeypatch.setattr(ref, "tc_gemm_ref", refuse)
    monkeypatch.setattr(tg, "_launch", lambda x, w: calls.append(
        (tuple(x.shape), tuple(w.shape))) or x.new_empty(
            (x.shape[0], w.shape[1])))
    x, w = torch.empty((3, 64), device="meta"), _w(64, 32, "nk")
    tg._impl(x, w)
    assert calls == [((3, 64), (64, 32))]


def _meta_forward(cfg):
    """One split forward of ``cfg`` on ``meta`` through
    ``fastpath.build_forward``'s fake path (every layer's products on the
    op) under the accountant."""
    model = DecoderLM(cfg)
    params = model.param_structs()
    fwd = fp.build_forward(model, cfg.split_layer, 8, (), "fake", 2)
    tokens = torch.zeros((2, 16), dtype=torch.long, device="meta")
    lengths = torch.full((2,), 16, dtype=torch.long, device="meta")
    return oc.analyze(fwd, params, params, tokens, lengths)


def test_meta_split_forward_has_no_blas_product():
    """qwen2-smoke's split forward on ``meta`` (fake path: the agent's
    products on the op too): no ``aten.mm``/``addmm``/``bmm``, 7
    ``tc_gemm`` calls a layer and one for the head, and their FLOPs the
    forward's products'."""
    cfg = get_smoke("qwen2-0.5b")
    c = _meta_forward(cfg)
    assert not set(MATMULS) & set(c.op_bytes), c.op_bytes
    assert c.kernel_calls["tc_gemm"] == 7 * cfg.n_layers + 1


def _count_serve(teng, tokens):
    out, c = oc.account(lambda: teng.serve_batch({"tokens": tokens})[0])
    return out, c


@pytest.mark.parametrize("kind,bits,path", [CASES[2], CASES[4]],
                         ids=["fake", "mixed-6-12"])
def test_engine_products_on_the_op_and_within_the_reference(
        engines, kind, bits, path):  # noqa: F811
    """The engine's split forward on the CPU (the products through the
    op, plain there): 7 ``tc_gemm`` calls a server layer and one for the
    head, 7 more an agent layer on the fake path or past 8 bits (the
    mixed plan's 12-bit layer; its 6-bit layer on ``qmm``), no other dense
    product (the attention's plain CPU version forms batched ones);
    logits within 1e-4 of the JAX reference engine's (its comparison,
    ``tests/test_torch_serve.py``), and bitwise the same forward through
    ``layers.matmul_group`` and ``torch.matmul``."""
    from repro.core.quantization import QuantPlan as JQuantPlan
    from repro_torch.core.quantization import QuantPlan
    jeng, _, teng, tokens = engines
    if kind == "plan":
        jeng.configure(JQuantPlan.from_layer_bits(bits))
        teng.configure(QuantPlan.from_layer_bits(bits))
    else:
        jeng.configure(bits)
        teng.configure(bits)
    assert teng.agent_path == path
    got, c = _count_serve(teng, tokens)
    cfg = teng.cfg
    fake = cfg.split_layer if path == "fake" else (
        sum(b > 8 for b in bits) if kind == "plan" else 0)
    assert c.kernel_calls.get("tc_gemm", 0) == \
        7 * (cfg.n_layers - cfg.split_layer + fake) + 1
    assert not {"aten.mm", "aten.addmm"} & set(c.op_bytes), c.op_bytes
    want, _ = jeng.serve_batch({"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "tc_matmul", torch.matmul)
        mp.setattr(L, "tc_matmul_group", L.matmul_group)
        plain, _ = teng.serve_batch({"tokens": tokens})
    assert torch.equal(got, plain)


def test_build_forward_cpu_bitwise_matmul_group():
    """The compiled path's closure (``fastpath.build_forward``) on the
    CPU at qwen2-smoke: bitwise the same forward with the products
    through ``matmul_group`` and the head through ``torch.matmul``."""
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), n_layers=3,
                              split_layer=1)
    model = DecoderLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    fwd = fp.build_forward(model, cfg.split_layer, 8, (), "fake", 2)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    lengths = torch.tensor([12, 7])
    got = fwd(params, params, tokens, lengths)
    x, pos = model.embed(params, {"tokens": tokens})
    x, _ = model.run_layers_window(params, x, pos, 0, cfg.split_layer)
    x = fp.transport_quantize(x, lengths, 8, 2)
    x, _ = model.run_layers_window(params, x, pos, cfg.split_layer,
                                   cfg.n_layers)
    x = L.apply_norm(cfg, x, params["final_norm"])
    assert torch.equal(got, L.unembed(cfg, params["embed"], x))
