"""The port's last four subcommands (`times`, `features`,
`intensity-report`, `view`) against the JAX CLI's, in process, on the same
arguments (`tiny_test` profile, the port's `features` with `--device cpu`).

Tolerances: none. Every printed line is compared as a string. `features`
prints statistics of run_window's integer outputs (point clusters, types,
valid rows) taken over the scan's float points in numpy, so its lines are
identical; the other three read files only. The figures are compared by
their pixel size (the PNG bytes carry the renderer's metadata).
"""

import contextlib
import io
import re

import numpy as np
import pytest

from dr_using_scv_od_tpu import cli as jcli
from dr_using_scv_od_tpu_torch import cli
from dr_using_scv_od_tpu_torch.utils import artifacts, io_kitti

TINY = ["--profile", "tiny_test", "--scene", "tiny"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    assert rc == 0
    return buf.getvalue().splitlines()


def _png_size(path):
    from PIL import Image
    with Image.open(path) as im:
        return im.size


def _subcommands(main):
    """The subcommand names argparse lists when given an unknown one."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        main(["no-such-command"])
    listed = err.getvalue().split("choose from", 1)[1].split(")", 1)[0]
    return sorted(re.findall(r"[a-z0-9][a-z0-9-]*", listed))


def test_registers_the_same_subcommands():
    names = _subcommands(cli.main)
    assert names == _subcommands(jcli.main) and len(names) == 17
    assert {"times", "features", "intensity-report", "view"} <= set(names)


def test_features_prints_the_same_lines(tmp_path):
    argv = ["features", *TINY, "--frames", 3, "--plot", tmp_path / "jax.png"]
    want = _run(jcli.main, argv)
    got = _run(cli.main, ["features", "--device", "cpu", *TINY, "--frames",
                          3, "--plot", tmp_path / "port.png"])
    assert got[:-1] == want[:-1]
    assert got[-1] == f"figure -> {tmp_path / 'port.png'}"
    assert sum(line.endswith(":") for line in got) >= 2   # classes
    assert _png_size(tmp_path / "port.png") == _png_size(tmp_path / "jax.png")


def test_features_default_device_raises_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is visible")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.main(["features", *TINY, "--frames", "2"])


def test_times_on_a_segdf_log(tmp_path):
    """`times` over the time.txt that the port's `segdf --out` wrote, and
    over a JSON dump with named stages."""
    _run(cli.main, ["segdf", "--device", "cpu", *TINY, "--frames", 2,
                    "--estimate-poses", "--out", tmp_path])
    log = tmp_path / "time.txt"
    for extra in ([], ["--names", "odometry,pipeline"]):
        want = _run(jcli.main, ["times", "--log", log, *extra,
                                "--plot", tmp_path / "jax.png"])
        got = _run(cli.main, ["times", "--log", log, *extra,
                              "--plot", tmp_path / "port.png"])
        assert got[:-1] == want[:-1] and len(got) == 4
        assert got[-1].startswith("figure -> ")
        assert _png_size(tmp_path / "port.png") == \
            _png_size(tmp_path / "jax.png")
    js = tmp_path / "t.json"
    js.write_text('{"rows": [{"seg": 4.0, "track": 1.5}, '
                  '{"seg": 6.0, "track": 2.5}]}')
    assert _run(cli.main, ["times", "--log", js]) == \
        _run(jcli.main, ["times", "--log", js]) == \
        ["  seg: 5.00 ms", "  track: 2.00 ms",
         "  total: 7.00 ms over 2 frames"]


def test_intensity_report_matches(tmp_path):
    rng = np.random.default_rng(0)
    count = rng.integers(0, 4, 300)
    artifacts.record_intensity(tmp_path / "7", count,
                               rng.uniform(0, 60, 300).astype(np.float32),
                               rng.uniform(0, 400, 300).astype(np.float32))
    for extra in ([], ["--bins", 6]):
        want = _run(jcli.main, ["intensity-report", "--prefix",
                                tmp_path / "7", *extra])
        got = _run(cli.main, ["intensity-report", "--prefix",
                              tmp_path / "7", *extra])
        assert got == want and got[0].startswith(
            f"voxels={int((count > 0).sum())}  ")
    want = _run(jcli.main, ["intensity-report", "--prefix", tmp_path / "7",
                            "--plot", tmp_path / "jax.png"])
    got = _run(cli.main, ["intensity-report", "--prefix", tmp_path / "7",
                          "--plot", tmp_path / "port.png"])
    assert got[:-1] == want[:-1]
    assert _png_size(tmp_path / "port.png") == _png_size(tmp_path / "jax.png")


@pytest.mark.parametrize("uniform", [False, True], ids=["rgb", "uniform"])
def test_view_matches(tmp_path, uniform):
    """A coloured segmentation PCD (the kind segdf writes) and a plain
    XYZI PCD; `--max-points` below the cloud size samples it."""
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(500, 3)).astype(np.float32) * 5
    pc = rng.integers(-1, 6, 500).astype(np.int32)
    xyzrgb = artifacts.colored_segmentation(
        xyz, pc, np.array([0, 1, 2, 2, 1, 0], np.int32),
        np.array([0, 0, 1, 0, -1, 0], np.int32),
        np.arange(6, dtype=np.int32))
    artifacts.write_colored_pcd(tmp_path / "seg.pcd", xyzrgb)
    io_kitti.write_pcd_xyzi(tmp_path / "plain.pcd",
                            np.c_[xyz, np.ones(500, np.float32)])
    flag = ["--uniform"] if uniform else []
    for name in ("seg", "plain"):
        argv = ["view", "--pcd", tmp_path / f"{name}.pcd", "--max-points",
                300, *flag]
        want = _run(jcli.main, argv + ["--out", tmp_path / "jax.png"])
        got = _run(cli.main, argv + ["--out", tmp_path / "port.png"])
        assert got == [line.replace("jax.png", "port.png") for line in want]
        assert got == [f"300 pts -> {tmp_path / 'port.png'}"]
        assert _png_size(tmp_path / "port.png") == \
            _png_size(tmp_path / "jax.png")
