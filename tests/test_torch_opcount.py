"""The port's per-device cost accounting (``repro_torch/launch/opcount.py``),
its kernel ops and the fused attention accounting ops, against the JAX
package on the CPU.

* The accountant's units, the reference's ``test_hloparse_*`` cases: a
  plain matmul at exactly 2·m·k·n, a loop of L products at L times one,
  dtype bytes, views free, and collective bytes over the fake process
  group (a subprocess: the group is process-wide).
* FLOP parity: the port's ``analyze`` of ``prefill``, ``decode_step`` and
  the loss-and-gradients step of qwen2-0.5b's and qwen3-moe's smoke
  configs on the CPU, against ``hloparse.analyze`` of the reference's
  jitted functions, within 1 %.  Every dot but one is equal; the one that
  differs (qwen3-moe's gradient, +0.07 %) is the combine einsum's
  gradient with respect to the gate weights, a batched product in
  PyTorch's einsum backward and a multiply-reduce in XLA's.  On ``meta``
  tensors (the dry-run's, the card's program: the flash op and the
  decode step's ``row_gemm``) prefill and decode equal the reference's,
  and the gradient step adds exactly one attention forward a layer: the
  flash backward's recompute through the plain attention.
* ``torch.library.opcheck`` on every kernel op and accounting op (their
  CPU impls), the fake versions refusing what the kernels refuse, and the
  FLOP formulas.
* ``fused_attention_acct`` and ``fused_decode_attention_acct`` against
  the reference's on a one-device mesh (values rtol 2e-5, gradients
  1e-4), the decode partials' combine over two shards against one
  (the reference's ``test_decode_partials_host_combine``).
"""

import _torch_threads  # noqa: F401  (one torch thread: see the module)

import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.launch import hloparse
from repro.launch.mesh import make_host_mesh
from repro.models import layers as RL
from repro.models.registry import build_model as ref_build
from repro_torch.configs import get_smoke
from repro_torch.launch import opcount as oc
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import layers as L
from repro_torch.models.lm import tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.parallel.sharding import flash_attention_mode

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = {n: importlib.import_module(f"repro_torch.kernels.{n}")
     for n in ("qmm", "quantize", "decode_attn", "flash", "row_gemm", "ref")}


# ---------------------------------------------------------------------------
# accountant units (the reference's test_hloparse_* cases)
# ---------------------------------------------------------------------------

def test_counts_plain_matmul():
    m, k, n = 64, 32, 16
    c = oc.analyze(lambda a, b: a @ b, torch.zeros(m, k), torch.zeros(k, n))
    assert c.flops == 2 * m * k * n
    assert c.n_dots == 1
    assert c.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert c.op_bytes == {"aten.mm": c.hbm_bytes}
    assert (c.n_while, c.trip_counts) == (0, [])


def test_loop_of_products_is_l_times_one():
    def f(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    n_layers, d = 8, 16
    c = oc.analyze(f, torch.zeros(4, d), torch.zeros(n_layers, d, d))
    assert c.flops == n_layers * 2 * 4 * d * d
    assert c.n_dots == n_layers


def test_dtype_bytes():
    assert oc.tensor_bytes(torch.zeros(4, 8)) == 128
    assert oc.tensor_bytes(torch.zeros(10, dtype=torch.bfloat16)) == 20
    assert oc.tensor_bytes(torch.zeros(4, dtype=torch.int8)) \
        + oc.tensor_bytes(torch.zeros(2)) == 12
    assert oc.tensor_bytes(torch.zeros((), dtype=torch.bool)) == 1
    # a broadcast operand holds its elements once
    assert oc.tensor_bytes(torch.zeros(8)[None].expand(5, 8)) == 32
    assert oc.tensor_bytes(torch.zeros(0, 3)) == 0


def test_views_and_allocations_are_free():
    x = torch.zeros(4, 6)
    c = oc.analyze(lambda t: t.view(24).reshape(6, 4).T[None].expand(
        3, 4, 6).detach(), x)
    assert c.hbm_bytes == 0 and c.flops == 0
    c = oc.analyze(lambda: torch.empty(100))
    assert c.hbm_bytes == 0
    assert c.peak_bytes == 400          # the allocation is alive at once
    c = oc.analyze(lambda t: t + 1, x)  # read 96 bytes, write 96
    assert c.hbm_bytes == 192


def test_collective_bytes_over_the_fake_group():
    code = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import opcount as oc
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
x = torch.zeros(8)
def step():
    dist.all_reduce(x)
    parts = [torch.empty_like(x) for _ in range(4)]
    dist.all_gather(parts, x)
    out = torch.empty(2)
    dist.reduce_scatter(out, [torch.zeros(2) for _ in range(4)])
    dist.broadcast(x, 0)
c = oc.analyze(step)
print(sorted(c.collective_breakdown.items()), c.collective_bytes)
dist.destroy_process_group()
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    # all-reduce: the 32-byte operand; all-gather: 4 x 32 result bytes;
    # reduce-scatter: the 4 x 8-byte operands; broadcast: its 32 bytes
    assert out.stdout.split("]")[0] + "]" == str(sorted({
        "all-reduce": 32.0, "all-gather": 128.0, "reduce-scatter": 32.0,
        "broadcast": 32.0}.items()))
    assert float(out.stdout.split("]")[1]) == 224.0


# ---------------------------------------------------------------------------
# FLOP parity with the reference's HLO census
# ---------------------------------------------------------------------------

B, S = 2, 32
_REF = {}


def _ref_costs(arch):
    """hloparse.analyze of the reference's jitted prefill, decode step and
    value-and-grad of the loss (once per arch)."""
    if arch not in _REF:
        model = ref_build(ref_smoke(arch))
        params = model.init(jax.random.PRNGKey(0))
        tok = np.zeros((B, S), np.int32)

        def census(fn, *args):
            return hloparse.analyze(jax.jit(fn).lower(*args).compile()
                                    .as_text())
        _REF[arch] = {
            "prefill": census(lambda p, b: model.prefill(p, b), params,
                              {"tokens": tok}),
            "decode": census(lambda p, c, b: model.decode_step(p, c, b),
                             params, model.init_cache(B, S),
                             {"token": tok[:, :1],
                              "pos": np.zeros(B, np.int32)}),
            "grad": census(lambda p, b: jax.value_and_grad(model.loss)(p, b),
                           params, {"tokens": tok, "labels": tok})}
    return _REF[arch]


def _port_costs(arch, step, device):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model._build(None, device=device)
    tok = torch.zeros((B, S), dtype=torch.int32, device=device)
    if step == "prefill":
        return oc.analyze(lambda: model.prefill(params, {"tokens": tok}))
    if step == "decode":
        cache = model.init_cache(B, S, device=device)
        return oc.analyze(lambda: model.decode_step(
            params, cache, {"token": tok[:, :1],
                            "pos": torch.zeros(B, dtype=torch.int32,
                                               device=device)}))
    for t in tree_leaves(params):
        t.requires_grad_(True)

    def grad():
        loss = model.loss(params, {"tokens": tok, "labels": tok},
                          remat=True)
        loss.backward()
        return loss
    return oc.analyze(grad)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("step", ["prefill", "decode", "grad"])
def test_flops_match_the_reference_census(arch, step):
    ref = _ref_costs(arch)[step].flops
    port = _port_costs(arch, step, "cpu").flops
    assert port == pytest.approx(ref, rel=1e-2)
    if not (arch.startswith("qwen3") and step == "grad"):
        assert port == ref


@pytest.mark.parametrize("step", ["prefill", "decode", "grad"])
def test_flops_of_the_cards_program(step):
    """On meta tensors the step takes the card's kernels (the flash op,
    ``row_gemm``); their formulas give the reference's count, and the
    gradient step adds the flash backward's recompute of each layer's
    attention forward (q kᵀ and p v, 4·B·H·S·T·dh)."""
    cfg = get_smoke("qwen2-0.5b")
    ref = _ref_costs("qwen2-0.5b")[step].flops
    port = _port_costs("qwen2-0.5b", step, "meta")
    extra = cfg.n_layers * 4 * B * cfg.n_heads * S * S * cfg.head_dim \
        if step == "grad" else 0
    assert port.flops == ref + extra
    want = {"prefill": {"flash_attention_fwd": cfg.n_layers},
            "decode": {"row_gemm_group": 3 * cfg.n_layers,
                       "row_gemm": cfg.n_layers + 1},
            "grad": {"flash_attention_fwd": 2 * cfg.n_layers}}[step]
    assert port.kernel_calls == want


# ---------------------------------------------------------------------------
# the kernel ops
# ---------------------------------------------------------------------------

def _op_cases():
    torch.manual_seed(0)
    x, w = torch.randn(5, 64), torch.randn(64, 32)
    codes, scales = K["quantize"].group_quantize(w, group_size=32)
    packed = K["ref"].pack_int4_ref(
        K["quantize"].group_quantize(w, group_size=32, bits=4)[0])
    q = torch.randn(2, 1, 4, 16)
    kc = torch.randint(-127, 127, (2, 32, 2, 16), dtype=torch.int8)
    ks = torch.rand(2, 32, 2)
    qq, kk = torch.randn(2, 4, 24, 16), torch.randn(2, 2, 24, 16)
    ql, kl = torch.randn(2, 24, 4, 16), torch.randn(2, 24, 2, 16)
    return [
        ("qmm", K["qmm"].qmm_op, (x, codes, scales)),
        ("qmm_int4", K["qmm"].qmm_int4_op, (x, packed, scales)),
        ("group_quantize", K["quantize"].group_quantize_op,
         ([w, torch.randn(32, 8)], [32, 16], [8, 4], True)),
        ("decode_attention", K["decode_attn"].decode_attention_op,
         (q, kc, kc.clone(), ks, ks.clone(), torch.tensor([3, 20]), 0, 0,
          16)),
        ("decode_attention_int", K["decode_attn"].decode_attention_op,
         (q, kc, kc.clone(), ks, ks.clone(), None, 20, 8, 16)),
        ("flash", K["flash"].flash_attention_op,
         (qq, kk, kk.clone(), None, -1, True, 0, 512, 512)),
        ("flash_kv_len", K["flash"].flash_attention_op,
         (qq, kk, kk.clone(), torch.tensor([5, 24]), 0, False, 0, 512,
          512)),
        ("row_gemm", K["row_gemm"].row_gemm_op, (x, w)),
        ("row_gemm_group", K["row_gemm"].row_gemm_group_op,
         (x, [w, torch.randn(64, 8)], [None, torch.randn(8)])),
        ("fused_attention_acct", L._fused_attention_op,
         (ql.requires_grad_(True), kl.requires_grad_(True),
          kl.clone().detach().requires_grad_(True), True, 0)),
        ("fused_attention_acct_bwd", L._fused_attention_bwd_op,
         (ql.detach(), kl.detach(), kl.detach(), torch.randn(2, 24, 4, 16),
          False, 4)),
        ("fused_decode_attention_acct", L._fused_decode_op,
         (q, torch.randn(2, 32, 2, 16), torch.randn(2, 32, 2, 16),
          torch.tensor([32, 11], dtype=torch.int32), 0, 0)),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_opcheck(case):
    _, op, args = case
    torch.library.opcheck(op, args)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_fake_versions_refuse_what_the_kernels_refuse():
    q, k = _meta(1, 2, 8, 160), _meta(1, 2, 8, 160)
    with pytest.raises(ValueError, match="head_dim"):
        K["flash"].flash_attention_fwd(q, k, k)
    q16 = _meta(1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K["flash"].flash_attention_fwd(q16, q16, q16)
    x, w = _meta(4, 64, dtype=torch.bfloat16), _meta(64, 32,
                                                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        K["row_gemm"].row_gemm(x, w)
    with pytest.raises(ValueError, match="aligned"):   # w is read in place
        K["row_gemm"].row_gemm(_meta(4, 64), _meta(64 * 32 + 1)[1:].view(
            64, 32))
    with pytest.raises(ValueError, match="shared memory"):
        K["decode_attn"].quantized_decode_attention(
            _meta(1, 1, 512, 128), _meta(1, 64, 1, 128), _meta(1, 64, 1, 128),
            _meta(1, 64, 1), _meta(1, 64, 1), 10)
    with pytest.raises(ValueError, match="S == T"):
        L.fused_attention_acct(_meta(1, 4, 2, 16), _meta(1, 8, 2, 16),
                               _meta(1, 8, 2, 16), causal=True, mesh=None)
    # what the kernels take runs, allocating nothing
    out = K["flash"].flash_attention_fwd(_meta(1, 2, 8, 64),
                                         _meta(1, 2, 8, 64),
                                         _meta(1, 2, 8, 64))
    assert out.device.type == "meta" and out.shape == (1, 2, 8, 64)


def test_kernel_op_formulas():
    c = oc.analyze(lambda: K["qmm"].qmm(
        _meta(8, 64), _meta(64, 32, dtype=torch.int8), _meta(2, 32)))
    assert c.flops == 2 * 8 * 64 * 32 and c.kernel_calls == {"qmm": 1}
    c = oc.analyze(lambda: K["row_gemm"].row_gemm_group(
        _meta(3, 64), [_meta(64, 32), _meta(64, 8)]))
    assert c.flops == 2 * 3 * 64 * 40
    # flash: the blockwise census over the sequence padded to whole
    # blocks of min(512, seq_bucket): S = 100 pads to 128
    c = oc.analyze(lambda: K["flash"].flash_attention_fwd(
        _meta(2, 4, 100, 16), _meta(2, 2, 100, 16), _meta(2, 2, 100, 16)))
    assert c.flops == 4 * 2 * 4 * 128 * 128 * 16
    c = oc.analyze(lambda: K["decode_attn"].quantized_decode_attention(
        _meta(2, 1, 4, 16), _meta(2, 32, 2, 16, dtype=torch.int8),
        _meta(2, 32, 2, 16, dtype=torch.int8), _meta(2, 32, 2),
        _meta(2, 32, 2), 10))
    assert c.flops == 4 * 2 * 4 * 32 * 16
    c = oc.analyze(lambda: K["quantize"].group_quantize(_meta(64, 32),
                                                       group_size=32))
    assert c.flops == 0 and c.hbm_bytes == 4 * 64 * 32 + 64 * 32 + 4 * 64


# ---------------------------------------------------------------------------
# the fused attention accounting ops against the reference's
# ---------------------------------------------------------------------------

MESH = AbstractMesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("causal,window,s,t", [(True, 0, 48, 48),
                                               (True, 8, 48, 48),
                                               (False, 0, 24, 40)])
def test_fused_attention_acct_equals_the_reference(causal, window, s, t):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, s, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    g = rng.standard_normal((2, s, 6, 16)).astype(np.float32)
    mesh = make_host_mesh()

    def f(a, b, c):
        return jnp.sum(RL.fused_attention_acct(
            a, b, c, causal=causal, window=window, mesh=mesh) * g)
    ref = RL.fused_attention_acct(q, k, v, causal=causal, window=window,
                                  mesh=mesh)
    ref_grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = L.fused_attention_acct(*leaves, causal=causal, window=window,
                                 mesh=MESH)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    (out * torch.tensor(g)).sum().backward()
    for a, b in zip(leaves, ref_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [0, 6])
def test_fused_decode_attention_acct_equals_the_reference(window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    lens = np.asarray([40, 17, 1], np.int32)
    ref = RL.fused_decode_attention_acct(q, k, v, jnp.asarray(lens),
                                         window=window, mesh=make_host_mesh())
    out = L.fused_decode_attention_acct(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(lens), window=window, mesh=MESH)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_decode_partials_combine_over_two_shards():
    """Two shards' partials merged by the logsumexp rule equal the plain
    decode attention over the whole cache (the reference's
    ``test_decode_partials_host_combine``)."""
    rng = np.random.default_rng(5)
    b, h, kv, t, dh = 2, 4, 2, 32, 8
    q = torch.tensor(rng.standard_normal((b, 1, h, dh)), dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((b, t, kv, dh)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, t, kv, dh)), dtype=torch.float32)
    ln = torch.tensor([32, 11], dtype=torch.int32)
    whole = L.decode_attention(q, k, v, ln)
    half = t // 2
    parts = [L._decode_partials_host(0, q, k[:, i * half:(i + 1) * half],
                                     v[:, i * half:(i + 1) * half], ln,
                                     i * half) for i in (0, 1)]
    m_glob = torch.maximum(parts[0][1], parts[1][1])
    acc = l = 0.0
    for a, m, lp in parts:
        c = torch.where(torch.isfinite(m), torch.exp(m - m_glob), 0.0)
        acc = acc + a * c[:, None]
        l = l + lp * c
    out = (acc / torch.clamp(l[:, None], min=1e-30)).reshape(b, 1, h, dh)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_mode_routes_attention_through_the_opaque_op():
    """Under ``flash_attention_mode`` the model's attention is one
    accounting op a layer, billed q, k, v and out, with no FLOPs: the
    roofline adds the analytic attention term for ``flash`` records."""
    q, k = _meta(2, 64, 4, 16), _meta(2, 64, 2, 16)
    with flash_attention_mode(MESH):
        c = oc.analyze(lambda: L.blockwise_attention(q, k, k, causal=True))
    assert c.flops == 0
    assert c.kernel_calls == {"fused_attention_acct": 1}
    assert c.hbm_bytes == 4 * (2 * 2 * 64 * 4 * 16 + 2 * 2 * 64 * 2 * 16)
    c = oc.analyze(lambda: L.blockwise_attention(q, k, k, causal=True))
    assert c.kernel_calls == {"flash_attention_fwd": 1}
    assert c.flops == 4 * 2 * 4 * 64 * 64 * 16
