"""CLI surface tests (SURVEY.md §2.2 C26)."""
import json

import pytest

from ecc_ldpc_tpu.cli.main import main, parse_ebn0


def test_parse_ebn0():
    assert parse_ebn0("0:2:0.5") == (0.0, 0.5, 1.0, 1.5, 2.0)
    assert parse_ebn0("1,2.5,3") == (1.0, 2.5, 3.0)
    assert parse_ebn0("0:3") == (0.0, 1.0, 2.0, 3.0)


def test_codes_command(capsys):
    assert main(["codes"]) == 0
    out = capsys.readouterr().out
    assert "mackay1008" in out and "dvbs2" in out


def test_sweep_command(tmp_path, capsys):
    out_file = str(tmp_path / "res.json")
    rc = main([
        "sweep", "--code", "bpsk/256", "--ebn0", "4", "--batch", "128",
        "--min-frame-errors", "10", "--max-frames", "512", "--out", out_file,
    ])
    assert rc == 0
    table = capsys.readouterr().out
    assert "bpsk/256" in table
    data = json.loads(open(out_file).read())
    assert data[0]["ebn0_db"] == 4.0 and data[0]["frames"] >= 128


def test_missing_required_args():
    with pytest.raises(SystemExit):
        main(["sweep"])  # --ebn0 required


def test_cli_learn_writes_loadable_schedule_and_band(tmp_path):
    """One training run covers both contracts: the output is a loadable
    schedule, AND '--ebn0 lo:hi' is a training BAND (endpoints) — it must
    record ebn0_range_db [1.8, 2.6], not collapse to a 1-dB grid.
    (Merged from two tests: each compiled its own training step, ~45 s of
    fast-suite time for one extra assertion.)"""
    import json

    from ecc_ldpc_tpu.cli.main import main
    from ecc_ldpc_tpu.learn import load_schedule

    out = str(tmp_path / "sched.json")
    rc = main(["learn", "--code", "80211n/648/12", "--ebn0", "1.8:2.6",
               "--iters", "3", "--steps", "4", "--batch", "16",
               "--out", out])
    assert rc == 0
    p = load_schedule(out)
    assert p.iters == 3
    d = json.load(open(out))
    assert d["trained"]["ebn0_range_db"] == [1.8, 2.6]


def test_cli_learn_rejects_all_frozen(tmp_path):
    import pytest

    from ecc_ldpc_tpu.cli.main import main

    with pytest.raises(SystemExit, match="nothing to train"):
        main(["learn", "--ebn0", "2.0,2.4", "--alpha-only", "--beta-only",
              "--out", str(tmp_path / "s.json")])


def test_cli_plot(tmp_path, capsys):
    """plot renders ASCII curves from saved results."""
    import json

    from ecc_ldpc_tpu.cli.main import build_parser
    from ecc_ldpc_tpu.sim.runner import PointResult

    pts = [
        PointResult(code="c", decoder="d", ebn0_db=e, frames=1000,
                    bit_errors=be, frame_errors=fe,
                    message_bits_per_frame=100)
        for e, be, fe in ((0.0, 5000, 900), (1.0, 500, 90), (2.0, 5, 1),
                          (3.0, 0, 0))
    ]
    path = tmp_path / "r.json"
    path.write_text(json.dumps([p.to_json() for p in pts]))
    args = build_parser().parse_args(["plot", str(path)])
    assert args.fn(args) == 0
    out = capsys.readouterr().out
    assert "FER vs Eb/N0" in out and "c | d" in out
    assert "v = error-free" in out


def test_trap_command(tmp_path, capsys):
    out_file = str(tmp_path / "trap.json")
    rc = main([
        "trap", "--code", "80211n/648/12", "--decoder",
        "minsum/norm:0.8125/5", "--ebn0", "1.0", "--frames", "128",
        "--batch", "128", "--seed", "3", "--out", out_file,
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "failures" in out and "(a,b)" in out
    data = json.loads(open(out_file).read())
    assert data["frames"] == 128 and data["n_failures"] > 0
    assert data["histogram"] and data["dominant_sets"]


def test_single_host_rendezvous_is_a_no_op():
    """`sweep --mesh` calls maybe_init_distributed() with no arguments; on
    one host with no cluster manager JAX finds no coordinator, and the
    call must leave a single-process run, not fail."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    code = ("import jax\n"
            "from ecc_ldpc_tpu.dist import maybe_init_distributed\n"
            "maybe_init_distributed()\n"
            "print(jax.process_count())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "1"
