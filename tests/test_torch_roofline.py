"""The port's roofline model against the reference's.

The HLO collective parser and the ring formulas are a copy, so they
agree exactly. ``cell_roofline`` charges the H100's published rates;
with them patched to the reference's TPU v5e rates every output dict is
the reference's, value for value (the same float operations in the same
order). The LM records' archs are the ten LM-seed configs, loaded into
both packages."""
import json
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)

from repro.roofline import hlo as ref_hlo  # noqa: E402
from repro.roofline import model as ref_model  # noqa: E402
from repro.roofline import report as ref_report  # noqa: E402
from repro_torch.roofline import hlo, model, report  # noqa: E402
from torch_contrib_configs import register_contrib_configs  # noqa: E402

HLO = """\
HloModule step
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), replica_groups=[2,8]<=[16], to_apply=%add
  %ag = bf16[64,512]{1,0} all-gather(bf16[4,512]{1,0} %y), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %rs = f32[128]{0} reduce-scatter(f32[2048]{0} %z), replica_groups=[1,16]<=[16], dimensions={0}
  %a2a = (s32[8,16]{1,0}, s32[8,16]{1,0}) all-to-all(s32[8,16]{1,0} %p, s32[8,16]{1,0} %q), replica_groups={{0,1}}
  %cp = u8[4096]{0} collective-permute(u8[4096]{0} %w), source_target_pairs={{0,1},{1,0}}
  %ars = f32[32,32]{1,0} all-reduce-start(f32[32,32]{1,0} %v), replica_groups={{0,1,2,3,4,5,6,7}}
  %ard = f32[32,32]{1,0} all-reduce-done(f32[32,32]{1,0} %ars)
  %agn = s64[10]{0} all-gather(s64[5]{0} %g), dimensions={0}
  %add.1 = f32[] add(f32[] %a, f32[] %b)
"""

REFERENCE_RATES = dict(PEAK_FLOPS=197e12, INT32_OPS=197e12, HBM_BW=819e9,
                       NVLINK_BW=50e9)


def _full(flops, byts, wire, temp=3 * 2**30, args=2**29):
    return {"cost": {"flops": flops, "bytes_accessed": byts},
            "collectives": {"wire_bytes": wire},
            "memory": {"temp_bytes": temp, "argument_bytes": args}}


def _lm(arch, cell, kind, depth=True, mesh="16x16"):
    rec = {"arch": arch, "cell": cell, "mesh": mesh, "kind": kind, "ok": True,
           "full": _full(3.1e14, 2.2e11, 4.0e9)}
    if depth:
        rec["depth1"] = {"n_layers": 1, **_full(5.5e13, 4.1e10, 1.1e9)}
        rec["depth2"] = {"n_layers": 2, **_full(9.7e13, 7.3e10, 1.9e9)}
    return rec


RECORDS = [
    {"arch": "parbutterfly-count", "cell": "pl_large", "mesh": "16x16",
     "kind": "count", "ok": True, "full": _full(8.4e10, 2.9e11, 6.1e8)},
    {"arch": "parbutterfly-peel", "cell": "pl_large", "mesh": "16x16",
     "ok": True, "full": _full(1.0e12, 1.0e9, 0.0)},
    _lm("qwen3-4b", "train_4k", "train"),
    _lm("arctic-480b", "train_4k", "train"),
    _lm("zamba2-7b", "prefill_32k", "prefill"),
    _lm("rwkv6-3b", "train_4k", "train", depth=False),
    _lm("qwen2.5-32b", "train_4k", "train", mesh="2x16x16"),
    {"arch": "qwen3-4b", "cell": "train_4k", "mesh": "16x16", "ok": False,
     "error": "boom"},
    {"arch": "qwen3-4b", "cell": "long_500k", "mesh": "16x16",
     "skipped": "not subquadratic"},
]


@pytest.fixture
def archs(monkeypatch):
    register_contrib_configs(monkeypatch, "repro_torch.configs")
    register_contrib_configs(monkeypatch, "repro.configs")


@pytest.fixture
def reference_rates(monkeypatch):
    for name, val in REFERENCE_RATES.items():
        monkeypatch.setattr(model, name, val)


def test_parse_collectives():
    got = hlo.parse_collectives(HLO)
    assert got == ref_hlo.parse_collectives(HLO)
    assert [r["kind"] for r in got] == [
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "all-reduce", "all-gather"]
    # iota groups, list groups, a tuple result, the async pair once
    assert got[0] == {"kind": "all-reduce", "bytes": 1024 * 256 * 4,
                      "group": 8}
    assert got[1]["group"] == 4 and got[3]["bytes"] == 2 * 8 * 16 * 4
    assert got[5]["group"] == 8 and got[6]["group"] is None
    assert hlo.DTYPE_BYTES == ref_hlo.DTYPE_BYTES


def test_wire_bytes_and_summary():
    for rec in hlo.parse_collectives(HLO):
        assert hlo.wire_bytes(rec) == ref_hlo.wire_bytes(rec)
    assert hlo.wire_bytes({"kind": "all-reduce", "bytes": 800,
                           "group": 4}) == 1200.0
    got = hlo.collective_summary(HLO)
    assert got == ref_hlo.collective_summary(HLO)
    assert got["n_ops"] == 7 and got["by_kind"]["all-reduce"]["count"] == 2


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_cell_roofline_under_reference_rates(i, archs, reference_rates):
    rec = RECORDS[i]
    got = model.cell_roofline(rec)
    assert got == ref_model.cell_roofline(rec)
    assert (got is None) == (not rec.get("ok") or rec["mesh"] != "16x16")


def test_cell_roofline_h100_rates(archs):
    assert model.HBM_BW == 3.35e12 and model.PEAK_FLOPS == 989.4e12
    assert model.NVLINK_BW == 450e9
    assert model.INT32_OPS == 64 * 132 * 1.98e9
    bf = model.cell_roofline(RECORDS[0])
    full = RECORDS[0]["full"]
    assert bf["t_memory_s"] == full["cost"]["bytes_accessed"] / 3.35e12
    assert bf["t_compute_s"] == full["cost"]["flops"] / model.INT32_OPS
    assert bf["t_collective_s"] == full["collectives"]["wire_bytes"] / 450e9
    assert bf["dominant"] == "memory"
    assert model.cell_roofline(RECORDS[1])["dominant"] == "compute"
    lm = model.cell_roofline(RECORDS[2])
    want = ref_model.cell_roofline(RECORDS[2])
    assert lm["t_memory_s"] == lm["bytes_dev"] / 3.35e12
    assert lm["t_compute_s"] == lm["flops_dev"] / 989.4e12
    assert lm["t_collective_s"] == lm["wire_dev"] / 450e9
    for key in ("flops_dev", "bytes_dev", "wire_dev", "model_flops_dev",
                "useful_flops_frac", "basis", "temp_gib", "args_gib"):
        assert lm[key] == want[key], key


def test_decode_record_raises_in_both(archs):
    rec = _lm("qwen3-4b", "decode_32k", "decode")
    with pytest.raises(ModuleNotFoundError):
        ref_model.cell_roofline(rec)
    with pytest.raises(ModuleNotFoundError, match="contrib/models/"):
        model.cell_roofline(rec)


def _fake_models(monkeypatch, package):
    """A stand-in ``<package>.models.model`` with the contrib model's
    two names, so the decode branch runs in both packages."""
    def decode_state_specs(cfg, batch, seq):
        kvd = cfg.n_kv_heads * cfg.head_dim
        return {"k": ((cfg.n_layers, batch, seq, kvd), "bfloat16"),
                "v": ((cfg.n_layers, batch, seq, kvd), "bfloat16"),
                "extra": [{"h": ((cfg.n_layers, batch, 4), "float32")}, None],
                "length": ((), "int32")}

    pkg = types.ModuleType(f"{package}.models")
    mod = types.ModuleType(f"{package}.models.model")
    mod.decode_state_specs = decode_state_specs
    mod._is_spec_leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                                   and isinstance(x[0], tuple))
    pkg.model = mod
    monkeypatch.setitem(sys.modules, pkg.__name__, pkg)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


def test_decode_branch_matches_with_models_in_place(archs, reference_rates,
                                                    monkeypatch):
    _fake_models(monkeypatch, "repro_torch")
    _fake_models(monkeypatch, "repro")
    for cell in ("decode_32k", "long_500k"):
        rec = _lm("qwen3-4b", cell, "decode")
        got = model.cell_roofline(rec)
        assert got == ref_model.cell_roofline(rec)
        assert got["useful_flops_frac"] > 0


def _write(tmp_path):
    for i, rec in enumerate(RECORDS):
        with open(tmp_path / f"rec{i:02d}.json", "w") as f:
            json.dump(rec, f)


def test_report_rows_csv_markdown(tmp_path, archs, reference_rates):
    _write(tmp_path)
    rows, want = report.load_rows(str(tmp_path)), ref_report.load_rows(
        str(tmp_path))
    strip = lambda rs: [{k: v for k, v in r.items() if k != "advice"}
                        for r in rs]
    assert strip(rows) == strip(want)
    assert report.to_csv(rows) == ref_report.to_csv(want)
    assert report.to_markdown(rows) == ref_report.to_markdown(want)
    assert {r.get("skipped") for r in rows} >= {"not subquadratic"}
    assert any(r.get("error") == "boom" for r in rows)


def test_advice_speaks_of_the_card():
    row = {"dominant": "compute", "useful_flops_frac": 0.9}
    assert "tensor-core" in report._advice(row)
    assert "MXU" in ref_report._advice(row)
    row["useful_flops_frac"] = 0.1
    assert report._advice(row) == ref_report._advice(row)
    assert report._advice({"dominant": "memory"}) == ref_report._advice(
        {"dominant": "memory"})
    assert report._advice({"dominant": "collective"}).startswith("NVLink")


def test_report_cli(tmp_path, archs, monkeypatch, capsys):
    _write(tmp_path)
    csv, md = tmp_path / "out" / "r.csv", tmp_path / "out" / "r.md"
    (tmp_path / "out").mkdir()
    monkeypatch.setattr(sys, "argv", [
        "report", "--dir", str(tmp_path), "--csv", str(csv), "--md", str(md)])
    report.main()
    out = capsys.readouterr().out
    rows = report.load_rows(str(tmp_path))
    assert csv.read_text() == report.to_csv(rows)
    assert md.read_text() == report.to_markdown(rows)
    assert "parbutterfly-count/pl_large/16x16: HBM-bound" in out
