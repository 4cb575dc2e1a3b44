"""The port's CLI front ends against the JAX CLI's: ``synth`` (the captures
the notch and the beamformer are exercised on), ``acquire --notch`` (also
after decimation: K5's plain version, then the notch), ``acquire
--beamform`` with its MUSIC bearing, and the refusals.

Tolerances: ``synth`` is numpy in both packages, so its files are held
byte-identical and its report line for line. The acquisition reports hold
the same detected PRNs and code phases, Doppler within 0.6 Hz and strength
within 0.02 (the printed digits, one unit of slack), as
tests/test_torch_deep_acquire.py does.
"""

import tests._torch_cpu  # noqa: F401  # isort: skip (first: caps torch's threads)

import logging
import re

import pytest

from gypsum_tpu.cli.main import main as jax_main
from gypsum_tpu_torch.cli.main import main as port_main

_HIT = re.compile(r"^\* PRN\s+(\d+): strength\s+([\d.]+)\s+doppler\s+([-+\d.]+) Hz\s+"
                  r"code phase\s+(\d+)", re.MULTILINE)

SYNTH = {
    "cw": ["--duration", "0.3", "--cw", "12"],
    "array": ["--duration", "0.3", "--jam", "6", "--jam-azel", "300,12"],
    "cw_fast": ["--duration", "0.3", "--cw", "12", "--rate", "4.092e6"],
}


def _synth(main, directory, case, capsys):
    out = directory / f"{case}.npy"
    argv = ["synth", "--out", str(out), *SYNTH[case]]
    if case == "array":
        argv += ["--array-out", str(directory / "array.npy")]
    assert main(argv) == 0
    return capsys.readouterr().out.replace(str(directory), "DIR")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The JAX CLI's captures of every ``SYNTH`` case, and its reports."""
    import contextlib
    import io

    directory = tmp_path_factory.mktemp("jax_synth")
    reports = {}
    for case in SYNTH:
        buf = io.StringIO()
        argv = ["synth", "--out", str(directory / f"{case}.npy"), *SYNTH[case]]
        if case == "array":
            argv += ["--array-out", str(directory / "array.npy")]
        with contextlib.redirect_stdout(buf):
            assert jax_main(argv) == 0
        reports[case] = buf.getvalue().replace(str(directory), "DIR")
    return directory, reports


@pytest.mark.parametrize("case", ["cw", "array"])
def test_synth_writes_what_the_jax_cli_writes(case, captures, tmp_path, capsys):
    directory, reports = captures
    assert _synth(port_main, tmp_path, case, capsys) == reports[case]
    names = [f"{case}.npy"] + (["array.npy"] if case == "array" else [])
    for name in names:
        for suffix in ("", ".json"):
            assert (tmp_path / (name + suffix)).read_bytes() == (directory / (name + suffix)).read_bytes()


def _acquire(main, argv, capsys, device=()):
    assert main([*device, "acquire", *argv]) == 0
    return _HIT.findall(capsys.readouterr().out)


@pytest.mark.parametrize("case,flag", [("cw", "--notch"), ("cw_fast", "--notch"),
                                       ("array", "--beamform")])
def test_cli_acquire_front_ends_match_the_jax_cli(case, flag, captures, capsys, caplog):
    directory, _ = captures
    capture = directory / ("array.npy" if case == "array" else f"{case}.npy")
    argv = ["--file", str(capture), flag]
    with caplog.at_level(logging.INFO):
        want = _acquire(jax_main, argv, capsys)
        jax_logs = [r.getMessage() for r in caplog.records if "bearing" in r.getMessage()
                    or "interference:" in r.getMessage()]
        caplog.clear()
        got = _acquire(port_main, argv, capsys, device=("--device", "cpu"))
        port_logs = [r.getMessage() for r in caplog.records if "bearing" in r.getMessage()
                     or "interference:" in r.getMessage()]
    assert [(p, c) for p, _, _, c in got] == [(p, c) for p, _, _, c in want]
    assert {p for p, _, _, _ in got} == {"25", "28", "31", "32"}
    for (_, sa, da, _), (_, sb, db, _) in zip(want, got):
        assert abs(float(sa) - float(sb)) <= 0.02 and abs(float(da) - float(db)) <= 0.6
    assert port_logs == jax_logs and port_logs  # the excision line, or the bearing
    if flag == "--beamform":
        assert port_logs[0].startswith("interference bearing: azimuth 30")


def test_cli_beamform_refusals_match_the_jax_cli(captures):
    directory, _ = captures
    for argv, match in (
        (["--file", str(directory / "cw.npy"), "--beamform"], "needs a 2-D"),
        (["--file", str(directory / "array.npy")], "4-element array capture"),
    ):
        with pytest.raises(SystemExit, match=match) as jax_exit:
            jax_main(["acquire", *argv])
        with pytest.raises(SystemExit, match=match) as port_exit:
            port_main(["--device", "cpu", "acquire", *argv])
        assert str(port_exit.value) == str(jax_exit.value)
