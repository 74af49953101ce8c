"""The dry-run's variants that the reference names and the port computes
on their own layouts: the sequence-sharded KV cache (``long_500k``'s
``cache_seq -> data``, ``cacheshard``'s ``-> model``), sequence-parallel
compute where nothing is split (``notp``, ``seqshard``), the
int8-resident tree over a mesh (``int8w``) and ``F.rms_norm`` billed as
one op, on the CPU.

* Census parity.  The reference's own census (``hloparse`` of
  ``repro.launch.dryrun._cell_fn_and_args``'s program, jitted on a host
  mesh of four CPU devices, in a subprocess of its own) beside the port's
  ``run_config`` on a fake process group of the same mesh shape (another
  subprocess), for smoke cells: qwen2-smoke ``train`` under ``notp`` and
  ``seqshard``, ``prefill`` under ``seqshard``, ``notp`` and ``int8w``,
  ``decode`` under ``cacheshard`` and ``int8w`` at (data 1, model 2),
  qwen3-moe-smoke ``train`` under ``notp`` and jamba-smoke's
  long-context decode (B = 1, ``cache_seq -> data``) at (data 2, model
  1).  Statuses equal; FLOPs per device equal but for training's flash
  backward recompute, which the variant cell bills as its ``baseline``
  does; the partial-softmax merge's all-reduce appears where the
  reference's census has it, in its bytes; ``int8w``'s argument bytes
  equal the reference's.
* Real tensors on two gloo ranks (``tests/_torch_ranks.py``, one world
  for the module): decode steps over a sequence-sharded cache equal one
  rank's within 1e-5 of the logits' scale and every write lands on the
  shard that owns its position (qwen2-smoke and seamless-smoke, self-
  and cross-attention, over ``model`` with attention split by KV
  groups; jamba-smoke over ``data``); the ``notp`` fit at (data 1,
  model 2) with the sequence split is held against the reference's
  one-device fit at the training tolerance; ``int8w`` prefill and
  decode over (model 2) against the one-rank int8-resident forward.
* ``F.rms_norm`` on ``meta`` is one op each way; flash's query offset in
  its plain versions equals the masked attention on the rows it covers.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_fits import (LR, ref_fit, ref_grad_norm_spread,
                         ref_step_states, replicas_equal,
                         steps_within_training, within_training)
from _torch_ranks import join_world, put_inputs, start_world
from repro.configs import get_smoke as jget_smoke
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref as KR
from repro_torch.launch import opcount as oc
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
QWEN, MOE, JAMBA = "qwen2-0.5b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b"
SEAMLESS, XLSTM = "seamless-m4t-large-v2", "xlstm-350m"

#: (arch, kind, variant, (data, model), long-context) of the census
CELLS = [(QWEN, "train", "baseline", (1, 2), False),
         (QWEN, "train", "notp", (1, 2), False),
         (QWEN, "train", "seqshard", (1, 2), False),
         (QWEN, "prefill", "seqshard", (1, 2), False),
         (QWEN, "prefill", "notp", (1, 2), False),
         (QWEN, "prefill", "int8w", (1, 2), False),
         (QWEN, "prefill", "baseline", (1, 2), False),
         (QWEN, "decode", "baseline", (1, 2), False),
         (QWEN, "decode", "cacheshard", (1, 2), False),
         (QWEN, "decode", "int8w", (1, 2), False),
         (MOE, "train", "baseline", (1, 2), False),
         (MOE, "train", "notp", (1, 2), False),
         (JAMBA, "decode", "baseline", (2, 1), True),
         (JAMBA, "train", "baseline", (1, 2), False),
         (JAMBA, "train", "notp", (1, 2), False),
         (XLSTM, "train", "baseline", (1, 2), False),
         (XLSTM, "train", "notp", (1, 2), False)]
VARIANT_CELLS = [c for c in CELLS if c[2] != "baseline" or c[4]]

# both sides: the smoke shape of the cell's kind; the long-context cell is
# B = 1 under the name "long_500k" (its rules map cache_seq to data);
# decode in float32 (the port's decode cells), the rest in bfloat16
_SHAPE = """
import dataclasses
def shape_of(kind, long_ctx):
    s = smoke_shape(kind)
    return dataclasses.replace(s, global_batch=1, name="long_500k") \\
        if long_ctx else s
def cfg_of(arch, kind):
    c = get_smoke(arch)
    return c if kind == "decode" else D._to_bf16(c)
"""

REF_CODE = """
import json, sys
import jax
jax.devices()            # four host devices, before the dry-run's import
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke, smoke_shape
from repro.launch import dryrun as D, hloparse
from repro.launch.mesh import make_host_mesh, set_mesh
from repro.models.registry import build_model
from repro.parallel.sharding import activation_sharding, default_rules
""" + _SHAPE + """
out = []
for arch, kind, variant, (d, m), long_ctx in json.loads(sys.argv[1]):
    cfg, shape = cfg_of(arch, kind), shape_of(kind, long_ctx)
    mesh = make_host_mesh(d, m)
    rules = default_rules(cfg, long_context=long_ctx)
    if "cacheshard" in variant:
        rules["cache_seq"] = "model"
    if "notp" in variant:
        for k in ("heads", "kv", "kv_heads", "ffn", "vocab"):
            rules[k] = None
    rec = {"status": "ok"}
    try:
        fn, args, sh, donate = D._cell_fn_and_args(
            build_model(cfg), cfg, shape, variant, mesh, rules)
        seq = P("data", "model") if ("seqshard" in variant
                                     or "notp" in variant) else None
        with set_mesh(mesh), activation_sharding(seq):
            comp = jax.jit(fn, in_shardings=sh,
                           donate_argnums=donate).lower(*args).compile()
        c = hloparse.analyze(comp.as_text())
        rec.update(flops=c.flops, coll=c.collective_breakdown,
                   args=comp.memory_analysis().argument_size_in_bytes)
    except Exception as e:  # the reference's refusal is the record
        rec = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    out.append(rec)
print(json.dumps(out))
"""

PORT_CODE = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.configs import get_smoke, smoke_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
""" + _SHAPE + """
out = []
for arch, kind, variant, (d, m), long_ctx in json.loads(sys.argv[1]):
    mesh = make_mesh((d, m), ("data", "model"), ranks=range(d * m),
                     device="cpu")
    r = D.run_config(cfg_of(arch, kind), shape_of(kind, long_ctx), mesh,
                     variant)
    rec = {"status": r["status"]}
    if r["status"] == "ok":
        rec.update(flops=r["hlo"]["flops_per_device"],
                   coll=r["hlo"]["collective_breakdown"],
                   args=r["memory"]["argument_bytes"])
    else:
        rec["error"] = r["error"]
    out.append(rec)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Everything the module waits for, started at once: the censuses,
    each in a subprocess of its own (the reference's split in four: the
    recurrent families' training cells compile longest, jamba-smoke's a
    cell a process), the world of two gloo ranks with its inputs
    (:func:`_start_ranks`), and beside them in a thread the reference's
    fits the ranks and the tests compare with (:func:`_reference`)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = [[c] for c in CELLS if c[:2] == (JAMBA, "train")] \
        + [[c for c in CELLS if c[:2] == (XLSTM, "train")]]
    jobs = [(REF_CODE, cells) for cells in [
        [c for c in CELLS if all(c not in j for j in jobs)]] + jobs] \
        + [(PORT_CODE, CELLS)]
    procs = [(cells, subprocess.Popen(
        [sys.executable, "-c", code, json.dumps([list(c) for c in cells])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for code, cells in jobs]
    tmp = str(tmp_path_factory.mktemp("variants"))
    try:
        world = _start_ranks(tmp)
    except BaseException:
        for _, p in procs:
            p.kill()
        raise
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ref = pool.submit(_reference, tmp)
    pool.shutdown(wait=False)
    return procs, world, ref


def _reference(tmp):
    """The recurrent fits' states first (the ranks wait for them), then
    the decoder's fit."""
    steps = {}
    for a, (b, s) in NOTP_STEPS.items():
        steps[a] = ref_step_states(jget_smoke(a), a, b, s)
        put_inputs(tmp, f"notp_{a}", {"states": steps[a][0]})
    for a, (b, s) in NOTP_STEPS.items():
        steps[a] += (ref_grad_norm_spread(jget_smoke(a), a, b, s,
                                          steps[a][0]),)
    return steps, ref_fit(jget_smoke(QWEN), QWEN, FIT["B"], FIT["S"],
                          FIT["steps"])[1:]


@pytest.fixture(scope="module")
def census(started):
    """{cell: (reference record, port record)}."""
    recs = []
    for cells, p in started[0]:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, out[-2000:] + err[-4000:]
        recs.append(dict(zip(cells, json.loads(out.strip().splitlines()[-1]))))
    *refs, port = recs
    ref = {c: r for part in refs for c, r in part.items()}
    return {c: (ref[c], port[c]) for c in CELLS}


def _id(cell):
    arch, kind, variant, mesh, long_ctx = cell
    return f"{arch}-{kind}-{variant}-{mesh[0]}x{mesh[1]}" + (
        "-long" if long_ctx else "")


def _recompute(arch, model):
    """The flash backward's recompute of every layer's attention forward
    per device, 4 B H S T dh a layer over ``model`` ranks: what the port's
    gradient step adds to the reference's census
    (``test_torch_opcount.py::test_flops_of_the_cards_program``)."""
    cfg = get_smoke(arch)
    return cfg.n_layers * 4 * 2 * cfg.n_heads * 32 * 32 * cfg.head_dim \
        // model


@pytest.mark.parametrize("cell", VARIANT_CELLS, ids=_id)
def test_census_status_and_flops_equal_the_references(census, cell):
    """Each variant cell ends as the reference's does; its FLOPs per
    device are the reference's, and a training cell adds exactly what its
    ``baseline`` adds (the flash backward's recompute; qwen3-moe's
    ``baseline`` also carries its combine einsum's gradient, counted as a
    batched product by PyTorch and a multiply-reduce by XLA; the
    recurrent families' ``baseline`` the einsums' contraction orders,
    which torch and XLA choose apart)."""
    ref, port = census[cell]
    assert port["status"] == ref["status"], (ref, port)
    if ref["status"] != "ok":
        return
    arch, kind, _, mesh, long_ctx = cell
    extra = 0.0
    if kind == "train":
        rb, pb = census[(arch, "train", "baseline", mesh, long_ctx)]
        extra = pb["flops"] - rb["flops"]
        if arch == QWEN:
            assert extra == _recompute(arch, mesh[1])
    assert port["flops"] == ref["flops"] + extra, (ref, port)


def test_notp_training_bills_one_rank_share():
    """The cell of the motivation: qwen2-smoke ``train`` at (data 1,
    model 2) under ``notp`` bills the reference's 51,904,512 FLOPs per
    device and the recompute, not the one-device 105,906,176."""
    assert 51_904_512 + _recompute(QWEN, 2) == 52_953_088


@pytest.mark.parametrize("arch,ref_flops,port_flops", [
    (JAMBA, 197_885_952, 198_361_088), (XLSTM, 1_180_925_952,
                                        1_130_463_232)], ids=["jamba",
                                                              "xlstm"])
def test_recurrent_notp_training_bills_the_chunks_work(census, arch,
                                                       ref_flops,
                                                       port_flops):
    """The recurrent families' ``notp`` training at (data 1, model 2)
    bills the reference's FLOPs a device as their ``baseline`` does (the
    census test above): the Mamba, mLSTM and sLSTM layers' norms and
    projections run on the rank's chunk, the recurrences form the chunk's
    outputs only and sum their carried states over the ranks' positions.
    Before, every rank formed every layer's per-token work over the whole
    sequence: 259,375,104 (jamba-smoke) and 2,242,084,864 (xlstm-smoke)."""
    ref, port = census[(arch, "train", "notp", (1, 2), False)]
    assert (ref["flops"], port["flops"]) == (ref_flops, port_flops)


def test_merge_all_reduce_where_the_reference_has_one(census):
    """jamba-smoke's long-context step merges its attention partials over
    ``data`` in the reference's 288 bytes (one max, two sums); under
    ``cacheshard`` the decode step adds the reference's merge all-reduce
    and its q, k, v all-gather over ``model`` to ``baseline``'s."""
    ref, port = census[(JAMBA, "decode", "baseline", (2, 1), True)]
    assert ref["coll"] == {"all-reduce": 288.0}
    assert port["coll"] == ref["coll"]
    rb, pb = census[(QWEN, "decode", "baseline", (1, 2), False)]
    rc, pc = census[(QWEN, "decode", "cacheshard", (1, 2), False)]
    for kind in ("all-reduce", "all-gather"):
        added = rc["coll"].get(kind, 0) - rb["coll"].get(kind, 0)
        assert added > 0
        assert pc["coll"].get(kind, 0) - pb["coll"].get(kind, 0) == added


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_int8w_arguments_equal_the_references(census, kind):
    """int8 codes placed as the float leaves, scales replicated: this
    rank's argument bytes are the reference's, fewer than ``baseline``'s."""
    ref, port = census[(QWEN, kind, "int8w", (1, 2), False)]
    base = census[(QWEN, kind, "baseline", (1, 2), False)][1]
    assert port["args"] == ref["args"] < base["args"]


# ---------------------------------------------------------------------------
# real tensors on two gloo ranks
# ---------------------------------------------------------------------------

T = 32
SEQ_DECODE = {QWEN: "model", SEAMLESS: "model", JAMBA: "data"}
#: the recurrent families' ``notp`` fits, three steps each from the
#: reference's state before it: (batch, sequence).  Their grad norms are
#: held beside the reference's own spread under one-ulp perturbations of
#: its parameters (``ref_grad_norm_spread``):
#: at step 2 it exceeds 1e-4 of the grad norm
#: (``test_recurrent_fits_grad_norm_moves_by_an_ulp``)
NOTP_STEPS = {JAMBA: (4, 32), XLSTM: (4, 32)}
#: each row's position at the two steps: both shards written, and a
#: position past the cache (written at its last entry, on the last shard)
POS = [np.asarray([5, 20], np.int32), np.asarray([6, 40], np.int32)]
FIT = dict(B=4, S=32, steps=2)


def _decode_inputs(arch, seed):
    """A seeded cache of T positions (every attention cache, all KV heads;
    the recurrent states too), two steps' tokens and positions.  The
    encoder-decoder's caches give half their cell's length to the
    decoder's tokens and half to the frames: T each."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    rng = np.random.default_rng(seed)
    cache = {}
    for k, v in model.init_cache(2, 2 * T if arch == SEAMLESS
                                 else T).items():
        if k == "len":
            cache[k] = POS[0].copy()
        else:
            cache[k] = (0.5 * rng.standard_normal(tuple(v.shape))).astype(
                v.numpy().dtype)
    return {"seed": seed, "cache": cache,
            "tokens": [rng.integers(0, cfg.vocab_size, (2, 1)).astype(
                np.int32) for _ in POS], "pos": POS}


def _one_rank_decode(arch, inp):
    """The same steps on one rank over the whole cache."""
    model = build_model(get_smoke(arch))
    params = model.init(torch.Generator().manual_seed(inp["seed"]))
    cache = {k: torch.from_numpy(v.copy()) for k, v in inp["cache"].items()}
    logits = []
    with torch.no_grad():
        for tok, pos in zip(inp["tokens"], inp["pos"]):
            out, cache = model.decode_step(
                params, cache, {"token": torch.from_numpy(tok),
                                "pos": torch.from_numpy(pos)})
            logits.append(out.numpy())
    return logits, {k: v.numpy() for k, v in cache.items()}


def _int8w_inputs(seed):
    cfg = get_smoke(QWEN)
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    return {"seed": seed,
            "tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                np.int32),
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "token": rng.integers(0, cfg.vocab_size, (2, 1)).astype(
                np.int32),
            "pos": np.asarray([16, 21], np.int32)}


def _one_rank_int8w(inp):
    from repro_torch.core.quantization import QuantConfig, \
        quantize_tree_stacked
    model = build_model(get_smoke(QWEN))
    params = quantize_tree_stacked(
        model.init(torch.Generator().manual_seed(inp["seed"])),
        QuantConfig(bits=8, granularity="per-channel"))
    cache = {k: torch.from_numpy(inp[k].copy()) for k in ("k", "v")}
    cache["len"] = torch.from_numpy(inp["pos"])
    with torch.no_grad():
        logits, pre = model.prefill(
            params, {"tokens": torch.from_numpy(inp["tokens"])})
        step, _ = model.decode_step(
            params, cache, {"token": torch.from_numpy(inp["token"]),
                            "pos": torch.from_numpy(inp["pos"])})
    return {"prefill": logits.numpy(), "k": pre["k"].numpy(),
            "v": pre["v"].numpy(), "decode": step.numpy()}


def _start_ranks(tmp):
    """The two ranks' inputs and world: the sequence-sharded decode of
    each arch of SEQ_DECODE, the ``notp`` fit, ``int8w`` serving."""
    decode = {a: _decode_inputs(a, 11 + i)
              for i, a in enumerate(SEQ_DECODE)}
    for a, inp in decode.items():
        put_inputs(tmp, f"seqdec_{a}", inp)
    int8w = _int8w_inputs(13)
    put_inputs(tmp, "int8w", int8w)
    state, _, _ = ref_fit(jget_smoke(QWEN), QWEN, FIT["B"], FIT["S"],
                          steps=0)
    put_inputs(tmp, "plain", {"state": state, "tc": {}, "lr": LR})
    world = start_world(2, [
        *[("seq_decode", dict(arch=a, axis=ax))
          for a, ax in SEQ_DECODE.items()],
        ("fit_mesh", dict(shape=(1, 2), axes=("data", "model"),
                          steps=FIT["steps"], batch=FIT["B"],
                          seq=FIT["S"], inputs="plain",
                          spec=(("data",), "model"), notp=True)),
        ("int8w_serve", {}),
        *[("fit_steps", dict(shape=(1, 2), axes=("data", "model"),
                             arch=a, batch=b, seq=s, inputs=f"notp_{a}",
                             notp=True, spec=(("data",), "model")))
          for a, (b, s) in NOTP_STEPS.items()]], tmp, "variants")
    return world, decode, int8w


@pytest.fixture(scope="module")
def ranks(started):
    world, decode, int8w = started[1]
    try:
        got = join_world(world, timeout=600)
    finally:
        steps, fit = started[2].result()
    ref = {"fit": fit, "steps": steps}
    ref["decode"] = {a: _one_rank_decode(a, inp)
                     for a, inp in decode.items()}
    ref["inputs"] = decode
    ref["int8w"] = _one_rank_int8w(int8w)
    return ref, got


@pytest.mark.parametrize("index,arch", list(enumerate(SEQ_DECODE)),
                         ids=list(SEQ_DECODE))
def test_sequence_sharded_decode_equals_one_rank(ranks, index, arch):
    """Both ranks' logits within 1e-5 of the one-rank step's scale; each
    rank's half of every attention cache is the one-rank cache's there
    (the fresh entries on their owner, the clamped one on the last shard,
    the other positions as they were); the recurrent states alike."""
    ref, got = ranks
    want_logits, want_cache = ref["decode"][arch]
    half = T // 2
    for r in got:
        out = r[index]
        for a, b in zip(out["logits"], want_logits):
            scale = float(np.abs(b).max())
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)
        o = out["offset"]
        for k, v in out["cache"].items():
            want = want_cache[k]
            if k in ("k", "v", "ek", "ev"):
                want = want[:, :, o:o + half]
            np.testing.assert_allclose(v, want, rtol=0, atol=1e-5)
    # the writes: row 0 at positions 5, 6 (shard 0), row 1 at 20 and the
    # clamped 31 (shard 1); nothing else moved
    first = got[0][index]["cache"]["k"]
    second = got[1][index]["cache"]["k"]
    start = ref["inputs"][arch]["cache"]["k"]
    moved0 = np.argwhere(np.any(first != start[:, :, :half],
                                axis=(0, 3, 4)))
    moved1 = np.argwhere(np.any(second != start[:, :, half:],
                                axis=(0, 3, 4)))
    assert moved0.tolist() == [[0, 5], [0, 6]]
    assert moved1.tolist() == [[1, 20 - half], [1, T - 1 - half]]


def test_notp_fit_within_training_of_the_reference(ranks):
    """(data 1, model 2) under the ``notp`` rules with the sequence split
    over ``model``: the norms, projections and MLP on each rank's chunk,
    K/V all-gathered, the loss from each rank's chunk; loss, grad norm and
    lr within 1e-4 of the reference's one-device fit every step, the
    parameters at the training tolerance with every element within 2e-4;
    both ranks end bitwise equal."""
    ref, got = ranks
    index = len(SEQ_DECODE)
    for r in got:
        within_training(r[index], *ref["fit"], max_diff=2e-4)
    replicas_equal(got, index)


@pytest.mark.parametrize("index,arch", [
    (len(SEQ_DECODE) + 2 + i, a) for i, a in enumerate(NOTP_STEPS)],
    ids=list(NOTP_STEPS))
def test_recurrent_notp_fit_within_training_of_the_reference(ranks, index,
                                                             arch):
    """jamba-smoke and xlstm-smoke under the ``notp`` rules at (data 1,
    model 2), the sequence split over ``model``: the Mamba and mLSTM
    layers (not split over ``model``) on each rank's chunk, the sLSTM's
    ``wout`` on it; each of three steps from the reference's one-device
    state before it within the step-wise training tolerance
    (``steps_within_training``, the grad norm beside the reference's own
    one-ulp spread at that step); both ranks end bitwise equal."""
    ref, got = ranks
    for r in got:
        out = r[index]
        assert not any(out["flags"][k] for k in ("mamba", "mlstm"))
        steps_within_training(out, *ref["steps"][arch])
    replicas_equal(got, index)


@pytest.mark.parametrize("arch", list(NOTP_STEPS))
def test_recurrent_fits_grad_norm_moves_by_an_ulp(ranks, arch):
    """Why the recurrent fits' grad norms are held beside the reference's
    own spread: at step 2 the reference's grad norm moves by more than
    1e-4 of itself when its parameters move by one ulp
    (``ref_grad_norm_spread``), so no float32 run that rounds otherwise
    can be held at 1e-4 alone."""
    ref = ranks[0]
    _, hist, spread = ref["steps"][arch]
    assert spread[1] > 1e-4 * hist[1]["grad_norm"], (spread, hist)


def test_int8w_serving_over_model_equals_one_rank(ranks):
    """The int8-resident prefill and decode step over (data 1, model 2),
    attention split by KV groups: the first layer's cache (column-parallel
    products of the embeddings, nothing reduced) bitwise the one-rank
    cache's heads, the later layers' (after all-reduced partial sums) and
    the logits within 1e-4; both ranks hold as many bytes of codes and
    scales."""
    ref, got = ranks
    index = len(SEQ_DECODE) + 1
    want = ref["int8w"]
    for rank, r in enumerate(got):
        out = r[index]
        assert out["attn"]
        for key in ("k", "v"):
            mine = np.split(want[key], 2, axis=3)[rank]
            np.testing.assert_array_equal(out[key][0], mine[0])
            np.testing.assert_allclose(out[key], mine, rtol=1e-4, atol=1e-4)
        for key in ("prefill", "decode"):
            np.testing.assert_allclose(out[key], want[key], rtol=1e-4,
                                       atol=1e-4)
    assert got[0][index]["held"] == got[1][index]["held"]


# ---------------------------------------------------------------------------
# rms_norm on meta; flash at a query offset
# ---------------------------------------------------------------------------

def test_rms_norm_is_one_op_on_meta():
    """On ``meta`` the accountant bills ``F.rms_norm`` as the card's one
    fused op: it reads x and the gain and writes y and the per-row rstd
    the card's kernel writes for the backward (one op there too)."""
    x = torch.empty(6, 64, device="meta", requires_grad=True)
    w = torch.empty(64, device="meta", requires_grad=True)
    c = oc.analyze(lambda: L.rmsnorm(x, w))
    assert c.op_bytes == {"repro_norm.rms_norm": 4 * (6 * 64 + 64 + 6 * 64
                                                      + 6)}
    assert c.kernel_calls == {}

    def step():
        L.rmsnorm(x, w).backward(torch.empty(6, 64, device="meta"))
    c = oc.analyze(step)
    assert c.op_bytes["repro_norm.rms_norm_backward"] == 4 * (
        6 * 64 + 6 * 64 + 6 + 64 + 6 * 64 + 64)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0)])
def test_flash_offset_equals_the_masked_rows(causal, window):
    """A query chunk at offset ``o`` (rows o .. o + S/2 of a sequence)
    against every key: flash's plain version, its split emulation, the
    recompute oracle and the blockwise CPU loop equal the plain masked
    attention's rows it covers."""
    rng = np.random.default_rng(17)
    b, h, kv, s, dh = 2, 4, 2, 96, 16
    q = torch.tensor(rng.standard_normal((b, s, h, dh)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((b, s, kv, dh)),
                         dtype=torch.float32) for _ in range(2))
    whole = L._attention_fwd_host(q, k, v, causal, window)[0]
    for o in (32, 48):
        qc = q[:, o:o + s // 2]
        want = whole[:, o:o + s // 2].transpose(1, 2)
        tr = (qc.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        for got in (KR.flash_attention_ref(*tr, causal=causal,
                                           window=window, q_offset=o),
                    KR.flash_split_emulation(*tr, causal=causal,
                                             window=window, q_offset=o),
                    KR.ref_attention(*tr, causal, window, o),
                    L.blockwise_attention(qc, k, v, causal=causal,
                                          window=window,
                                          q_offset=o).transpose(1, 2),
                    L._attention_fwd_host(qc, k, v, causal, window,
                                          o)[0].transpose(1, 2)):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-5)
