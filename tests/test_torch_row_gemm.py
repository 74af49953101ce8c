"""The row-independent GEMM (``kernels.row_gemm``) on the CPU: its plain
version, its schedule, and the decode step it carries, against the JAX
reference.

* The decode step's logits, every projection and the tied head through
  ``layers.row_matmul`` (the plain version here), agree with the JAX
  reference's ``decode_step_q`` within rtol = atol = 1e-4 (the forward's
  tolerance) at B = 1, 3 and 4 from the same quantized cache state.
* Each row of ``row_gemm(x[:M], w)`` is bitwise the row computed alone at
  M = 1..8, for a row-major w and for the transposed view of the tied
  embedding, and the product agrees with a float64 one within 1e-5 of its
  scale.
* ``row_matmul`` on a [B, 1, K] activation is bitwise the per-leading-row
  loop the decode step used before.
* ``schedule`` (the kernel's split of K over a thread-block cluster and
  its ring of stages) covers K exactly in 4-aligned chunks, keeps every
  decode shape's chunk resident in shared memory, and is a function of K
  alone; what the wrapper hands the kernel is the same at every M
  (1 to 128), the row count aside.
* The grouped call (q | k | v, gate | up in one launch) is bitwise the
  separate products plus the bias add, and so are the decode layer's
  helpers built on it.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels.quantize import kv_quantize as jkv_quantize
from repro.models.registry import build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref, row_gemm
from repro_torch.models import layers as L
from repro_torch.models.lm import DecoderLM

# the module (the package's name ``row_gemm`` is the wrapper function)
rg_mod = importlib.import_module("repro_torch.kernels.row_gemm")

TOL4 = dict(rtol=1e-4, atol=1e-4)
# (K, N) of the decode step's products at qwen2-0.5b's full width
DECODE_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                 (896, 151936)]
# the same at stablelm-3b's (d_model 2560, kv 2560, d_ff 6912, vocab 50304)
SL_SHAPES = [(2560, 2560), (2560, 2560), (2560, 6912), (6912, 2560),
             (2560, 50304)]


@pytest.fixture(scope="module")
def qwen():
    jmodel = build_model(jget_smoke("qwen2-0.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jmodel, jparams, DecoderLM(get_smoke("qwen2-0.5b")), tparams


def _normal(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("b", [1, 3, 4])
@pytest.mark.parametrize("b_kv", [8, 16])
def test_decode_step_logits_match_reference(qwen, b, b_kv):
    jmodel, jparams, tmodel, tparams = qwen
    rng = np.random.default_rng(10 * b + b_kv)
    toks = rng.integers(0, 512, (b, 16)).astype(np.int32)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    k, v = jc["k"], jc["v"]
    if b_kv < 16:
        (kq, ks), (vq, vs) = (jax.jit(jkv_quantize, static_argnums=1)(
            a, b_kv) for a in (k, v))
    else:
        kq, vq = k, v
        ks = vs = jnp.ones(k.shape[:-1], jnp.float32)
    pad = [(0, 0), (0, 0), (0, 16), (0, 0), (0, 0)]
    state = {"k_codes": jnp.pad(kq, pad), "v_codes": jnp.pad(vq, pad),
             "k_scales": jnp.pad(ks, pad[:-1], constant_values=1.0),
             "v_scales": jnp.pad(vs, pad[:-1], constant_values=1.0)}
    pos = rng.integers(4, 17, (b,)).astype(np.int32)
    tok = rng.integers(0, 512, (b, 1)).astype(np.int32)
    step = jax.jit(lambda p, c, bt: jmodel.decode_step_q(p, c, bt,
                                                         b_kv=b_kv))
    want, _ = step(jparams, {**state, "len": jnp.asarray(pos)},
                   {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)})
    tstate = {n: torch.from_numpy(np.array(a)) for n, a in state.items()}
    got, _ = tmodel.decode_step_q(
        tparams, {**tstate, "len": torch.from_numpy(pos)},
        {"token": torch.from_numpy(tok), "pos": torch.from_numpy(pos)},
        b_kv=b_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL4)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m", range(1, 9))
def test_rows_are_bitwise_alone(m, transposed):
    k, n = 96, 200
    x = _normal(m, (8, k))
    w = _normal(100 + m, (n, k)).T if transposed else _normal(m, (k, n))
    y = row_gemm(x[:m], w)
    assert y.shape == (m, n) and y.dtype == torch.float32
    for i in range(m):
        assert torch.equal(y[i], row_gemm(x[i:i + 1], w)[0])
    want = x[:m].double().numpy() @ w.double().numpy()
    np.testing.assert_allclose(y.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()),
                               rtol=0)


def test_row_matmul_equals_the_per_row_loop():
    x = _normal(0, (4, 1, 64))
    for w in (_normal(1, (64, 48)), _normal(2, (80, 64)).T):
        old = torch.cat([x[i:i + 1] @ w for i in range(x.shape[0])])
        assert torch.equal(L.row_matmul(x, w), old)
    assert torch.equal(ref.row_gemm_ref(x[:0, 0], w),
                       torch.zeros((0, w.shape[1])))


@pytest.mark.parametrize("k,n", DECODE_SHAPES + SL_SHAPES + [
    (7, 8), (64, 4), (100, 12), (20000, 128)])
def test_schedule_covers_k_from_k_and_n_alone(k, n):
    assert list(inspect.signature(rg_mod.schedule).parameters) == ["k", "n"]
    s = rg_mod.schedule(k, n)
    assert s.chunk % 4 == 0 and s.chunk > 0
    assert (s.cluster - 1) * s.chunk < k <= s.cluster * s.chunk
    assert 1 <= s.cluster <= rg_mod.MAX_CLUSTER
    assert (s.pieces - 1) * rg_mod.PIECE < s.chunk <= s.pieces * rg_mod.PIECE
    assert s.stages == min(s.pieces, rg_mod.MAX_STAGES)
    assert s.stages * rg_mod.PIECE * rg_mod.TILE_N * 4 <= rg_mod.RING_BYTES
    if k >= rg_mod.MAX_CLUSTER * rg_mod.MIN_ROWS:
        assert s.cluster == rg_mod.MAX_CLUSTER
    elif k > rg_mod.MIN_ROWS:
        assert s.chunk >= rg_mod.MIN_ROWS - 4
    # the same for every N of one K: one cluster shape serves a group
    assert rg_mod.schedule(k, 4 * n + 64) == s
    if (k, n) in DECODE_SHAPES[:4] + SL_SHAPES[:4]:
        # the decode products: a block fits the card, and the chunks of
        # d_model rows stay resident in the ring (each row slice reads the
        # staged tile; the down projection's longer chunk streams through
        # the ring again for each slice past the first)
        assert rg_mod.smem_bytes(16, k, n, False) <= rg_mod.MAX_SMEM_BYTES
        assert (s.pieces <= s.stages) == (k in (896,))
    if k % 4 == 0:
        cols = rg_mod.head_columns(k)
        assert rg_mod.NK_THREADS % cols == 0
        assert rg_mod.head_ld(k) % 32 == 4 and rg_mod.head_ld(k) >= k
        assert rg_mod.smem_bytes(16, k, n, True) <= rg_mod.MAX_SMEM_BYTES


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k,n", DECODE_SHAPES + SL_SHAPES)
def test_launch_is_the_same_at_every_m(k, n, transposed):
    """What the wrapper hands the kernel besides the row count, the
    schedule and the head's columns, is the same at every M: only the
    registers held for rows (and with them the scratch of a block) follow
    M, and those change which rows are computed, not how."""
    plans = {m: (rg_mod.schedule(k, n), rg_mod.head_columns(k),
                 rg_mod.head_ld(k)) for m in (1, 4, 16, 17, 32, 128)}
    assert len(set(plans.values())) == 1
    for m in (17, 32, 128):
        assert rg_mod.row_block(m) == rg_mod.SLICE
        assert rg_mod.smem_bytes(m, k, n, transposed) == \
            rg_mod.smem_bytes(16, k, n, transposed)
    assert [rg_mod.row_block(m) for m in (1, 2, 3, 4, 5, 9, 16)] == \
        [1, 2, 4, 4, 8, 16, 16]


@pytest.mark.parametrize("m", [1, 4, 17, 32])
@pytest.mark.parametrize("bias", [False, True])
def test_grouped_plain_equals_separate_plus_bias(m, bias):
    """The grouped call's plain version is bitwise the separate products,
    each followed by its bias add: q | k | v and gate | up shapes."""
    x = _normal(m, (m, 64))
    ws = [_normal(10 + i, (64, n)) for i, n in enumerate((64, 16, 16))]
    bs = [_normal(20 + i, (w.shape[1],)) for i, w in enumerate(ws)]
    got = rg_mod.row_gemm_group(x, ws, bs if bias else None)
    for y, w, b in zip(got, ws, bs):
        want = row_gemm(x, w)
        assert torch.equal(y, want + b if bias else want)
    with pytest.raises(ValueError):
        rg_mod.row_gemm_group(x, ws * 2)              # > MAX_PRODUCTS
    with pytest.raises(ValueError):
        rg_mod.row_gemm_group(x, ws, bs[:2])


def test_decode_layer_helpers_equal_the_separate_products(qwen):
    """``qkv_project`` and ``apply_mlp`` with the decode step's
    ``products=row_matmul_group`` (q | k | v and gate | up grouped) are
    bitwise the same functions with every product its own ``row_matmul``
    followed by its bias add (qwen2 has biases)."""
    _, _, tmodel, tparams = qwen
    cfg = tmodel.cfg
    assert cfg.qkv_bias and cfg.act == "silu"

    def separate(x, ws, biases=None):
        ys = [L.row_matmul(x, w) for w in ws]
        return ys if biases is None else [y + b for y, b in zip(ys, biases)]

    p0 = {n: {k: a[0] for k, a in blk.items()}
          for n, blk in tparams["layers"].items() if isinstance(blk, dict)}
    p0["attn"]["bq"] = _normal(3, p0["attn"]["bq"].shape)
    h = _normal(1, (20, 1, cfg.d_model))
    pos = torch.arange(20, dtype=torch.int32)[:, None]
    got = L.qkv_project(cfg, p0["attn"], h, pos, products=L.row_matmul_group)
    want = L.qkv_project(cfg, p0["attn"], h, pos, products=separate)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        L.apply_mlp(cfg, p0["ffn"], h, products=L.row_matmul_group),
        L.apply_mlp(cfg, p0["ffn"], h, products=separate))


def test_bad_shapes_raise():
    x = _normal(0, (2, 8))
    with pytest.raises(ValueError):
        row_gemm(x, _normal(1, (9, 4)))
    with pytest.raises(ValueError):
        row_gemm(x[0], _normal(1, (8, 4)))


def _old_schedule(k):
    """The schedule before the ring was fitted to long chunks: the ring's
    stages were min(pieces, MAX_STAGES) at every K."""
    cluster = min(8, max(1, -(-k // 128)))
    chunk = -(-k // cluster)
    chunk = -(-chunk // 4) * 4
    cluster = -(-k // chunk)
    pieces = -(-chunk // 32)
    return (cluster, chunk, pieces, min(pieces, 4))


def test_schedule_unchanged_up_to_k_16384():
    """Every K <= 16,384 keeps the schedule it had (so qwen2-0.5b's,
    stablelm-3b's, llava's and internlm2's decode products keep their
    bits): only longer chunks get a shallower ring."""
    for k in range(1, 16385):
        assert tuple(rg_mod.schedule(k, 64)) == _old_schedule(k), k
    s = rg_mod.schedule(24576, 6144)
    assert (s.cluster, s.chunk, s.pieces) == _old_schedule(24576)[:3]
    assert s.stages == 3 < _old_schedule(24576)[3]


def _decode_products(cfg):
    """(K, N, transposed) of every row_gemm product of a decode step of
    ``cfg``: q | k | v and wo; gate | up (or the non-gated wi) and down,
    or an MoE layer's router; the head (the tied embedding's transposed
    view, or the untied [D, V])."""
    d = cfg.d_model
    out = [(d, cfg.q_dim, False), (d, cfg.kv_dim, False),
           (cfg.q_dim, d, False)]
    if cfg.n_experts:
        out.append((d, cfg.n_experts, False))
    else:
        out += [(d, cfg.d_ff, False), (cfg.d_ff, d, False)]
    out.append((d, cfg.vocab_size, bool(cfg.tie_embeddings)))
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "stablelm-3b",
                                  "granite-34b", "internlm2-20b",
                                  "llava-next-mistral-7b",
                                  "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
                                  "blip2-proxy", "git-proxy"])
def test_every_registered_decode_product_fits(arch):
    """A block of every decode product of every registered config fits
    the card's shared memory at any M (granite-34b's down projection,
    K = 24,576, raised at M >= 9 before its ring was fitted), and the
    products' layouts are ones the kernel takes."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    for k, n, tr in _decode_products(cfg):
        assert n % 4 == 0 and (not tr or k % 4 == 0), (k, n)
        for m in (1, 4, 8, 9, 16, 17, 128):
            assert rg_mod.smem_bytes(m, k, n, tr) <= rg_mod.MAX_SMEM_BYTES, \
                (arch, k, n, tr, m)
