"""``paddle_tpu_torch.tools.smoke_ab`` on stand-in smokes: each checkout's
smoke runs from its own root, its output lands under ``--out``, and the
JSON line a run carries its exit code and each phase's last time."""
import json

from paddle_tpu_torch.tools import smoke_ab

SMOKE = """import json, sys
for phase in ("build", "parity", "parity", "cluster"):
    print(json.dumps({"phase": phase}))
print("not json")
print(json.dumps({"ok": True}))
sys.exit(%d)
"""


def test_smoke_ab_runs_each_checkout_in_turn(tmp_path, capsys):
    roots = []
    for name, rc in (("parent", 0), ("change", 3)):
        root = tmp_path / name
        root.mkdir()
        (root / "chip_smoke.py").write_text(SMOKE % rc)
        roots.append(str(root))
    out = tmp_path / "out"
    assert smoke_ab.main(roots + ["--out", str(out)]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["root"] for r in lines] == roots
    assert [r["rc"] for r in lines] == [0, 3]
    for r in lines:
        assert sorted(r["phase_done_s"]) == ["build", "cluster", "parity"]
        assert r["last_line"] == '{"ok": true}' and r["seconds"] > 0
    log = (out / "parent.log").read_text().splitlines()
    assert log[-2:] == ["not json", '{"ok": true}'] and len(log) == 6
    assert (out / "change.err").read_text() == ""


def test_smoke_ab_phase_of():
    assert smoke_ab.phase_of('{"phase": "cluster", "seconds": 1}') \
        == "cluster"
    assert smoke_ab.phase_of('{"kernels": []}') is None
    assert smoke_ab.phase_of("NVIDIA H100 80GB HBM3, 700.00 W") is None
    assert smoke_ab.phase_of("{broken") is None
    assert smoke_ab.phase_of("[1, 2]") is None
