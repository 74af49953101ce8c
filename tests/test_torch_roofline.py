"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's (``repro/launch/roofline.py``) on the same records.

Records are built for every architecture x shape x mesh of the dry-run,
for ``baseline`` and ``flash``, with seeded per-device counts.  The model
FLOPs, the analytic attention term of ``flash`` records and the useful
ratio equal the reference's (rtol 1e-12); each term times the port's
constant equals the reference's term times the reference's constant (the
same counts, another card); a float32 record is divided by the float32
peak; the table functions keep the reference's columns.
"""

import _torch_threads  # noqa: F401  (one torch thread: see the module)

import json

import numpy as np
import pytest

from repro.configs import ALL_SHAPES, ARCH_IDS
from repro.launch import mesh as ref_mesh
from repro.launch import roofline as ref_rl
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import roofline as port_rl

RTOL = 1e-12


def _records():
    from repro.configs import get_config
    rng = np.random.default_rng(0)
    recs = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            for mesh in ("16x16", "2x16x16"):
                for variant in ("baseline", "flash"):
                    recs.append({
                        "arch": arch, "shape": shape.name, "mesh": mesh,
                        "variant": variant, "status": "ok",
                        "hlo": {
                            "flops_per_device": float(rng.uniform(1e12,
                                                                  1e16)),
                            "hbm_bytes_per_device": float(
                                rng.uniform(1e9, 1e13)),
                            "collective_bytes_per_device": float(
                                rng.uniform(0, 1e11)),
                            "collective_breakdown": {"all-reduce": 1.0},
                            "n_while": 0, "trip_counts": []},
                        "memory": {"argument_bytes": 1},
                        "model_stats": {
                            "params": cfg.param_count(),
                            "active_params": cfg.active_param_count(),
                            "tokens": shape.global_batch * (
                                shape.seq_len if shape.kind != "decode"
                                else 1),
                            "kind": shape.kind}})
    return recs


RECORDS = _records()


def test_model_and_attention_flops_equal_the_reference():
    for rec in RECORDS:
        assert port_rl.model_flops_per_device(rec) == pytest.approx(
            ref_rl.model_flops_per_device(rec), rel=RTOL)
        assert port_rl._attention_flops_per_device(rec) == pytest.approx(
            ref_rl._attention_flops_per_device(rec), rel=RTOL, abs=0.0)
    assert port_rl.CHIPS == ref_rl.CHIPS


@pytest.mark.parametrize("variant", ["baseline", "flash"])
def test_terms_scale_by_the_constants(variant):
    """The same counts on another card: each term times its constant is
    the reference's term times its constant; ratios equal."""
    pairs = [(ref_mesh.PEAK_FLOPS_BF16, port_mesh.PEAK_FLOPS_BF16,
              "compute_s"),
             (ref_mesh.HBM_BW, port_mesh.HBM_BW, "memory_s"),
             (ref_mesh.ICI_BW, port_mesh.NVLINK_BW, "collective_s")]
    for rec in (r for r in RECORDS if r["variant"] == variant):
        ref = ref_rl.roofline_terms(rec)
        port = port_rl.roofline_terms(rec)
        for c_ref, c_port, key in pairs:
            assert port[key] * c_port == pytest.approx(ref[key] * c_ref,
                                                       rel=RTOL)
        assert port["useful_ratio"] == pytest.approx(ref["useful_ratio"],
                                                     rel=RTOL)
        assert port["model_flops_dev"] == pytest.approx(
            ref["model_flops_dev"], rel=RTOL)
        assert port["ideal_s"] * port_mesh.PEAK_FLOPS_BF16 == \
            pytest.approx(ref["ideal_s"] * ref_mesh.PEAK_FLOPS_BF16,
                          rel=RTOL)
        assert set(port) == set(ref)


def test_float32_records_use_the_float32_peak():
    rec = dict(RECORDS[0], model_stats=dict(RECORDS[0]["model_stats"],
                                            dtype="float32"))
    t = port_rl.roofline_terms(rec)
    assert t["compute_s"] == pytest.approx(
        rec["hlo"]["flops_per_device"] / port_mesh.PEAK_FLOPS_F32, rel=RTOL)
    assert t["ideal_s"] == pytest.approx(
        port_rl.model_flops_per_device(rec) / port_mesh.PEAK_FLOPS_F32,
        rel=RTOL)
    bf16 = dict(rec, model_stats=dict(rec["model_stats"], dtype="bfloat16"))
    assert port_rl.roofline_terms(bf16)["compute_s"] == pytest.approx(
        rec["hlo"]["flops_per_device"] / port_mesh.PEAK_FLOPS_BF16,
        rel=RTOL)
    assert port_rl.roofline_terms(dict(rec, status="error")) is None


def test_tables_keep_the_reference_columns(tmp_path, capsys):
    rows_ref = [ref_rl.roofline_terms(r) for r in RECORDS[:8]]
    rows_port = [port_rl.roofline_terms(r) for r in RECORDS[:8]]
    md_ref = ref_rl.markdown_table(rows_ref).splitlines()
    md_port = port_rl.markdown_table(rows_port).splitlines()
    assert md_port[:2] == md_ref[:2]
    assert len(md_port) == len(md_ref)
    for a, b in zip(md_port[2:], md_ref[2:]):
        assert a.split("|")[1:5] == b.split("|")[1:5]
    cmp_port = port_rl.compare_table(rows_port[:4], rows_port[4:])
    assert cmp_port.splitlines()[:2] == \
        ref_rl.compare_table(rows_ref[:4], rows_ref[4:]).splitlines()[:2]
    for i, rec in enumerate(RECORDS[:8]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    assert len(port_rl.load_records(str(tmp_path))) == 8
    assert len(port_rl.load_records(str(tmp_path), "flash")) == 4
    assert port_rl.main(["--in", str(tmp_path), "--md"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == md_ref[0] and len(out) == 2 + 8
    assert port_rl.main(["--in", str(tmp_path), "--compare", "baseline",
                         "flash"]) == 0
