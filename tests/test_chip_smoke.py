"""chip_smoke.py off the card: its phases at tiny sizes on the CPU, its
refusal to run without a GPU, and its phase selection.

The phases compare a device under test with a reference device; here both
are the CPU, so the comparisons hold exactly and what is checked is the
phases' plumbing (problem construction, column slicing, McICA keying, the
f64 auto-chunk, the gradient). On a GPU host the ``gpu``-marked test runs the
same tiny phases with the GPU as the device under test.
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    nlay=8, lw=(16, 2), sw=(16, 2), gray_ncol=24, clear_ncol=(40, 20), allsky_ncol=36,
    f64_ncol=30, grad_ncol=12, mesh_ncol=4 * 9, ncmp=8, steps=1,
    # three columns' worth of the f64 pair: phase 5's chunked solve chunks
    f64_chunk_gb=3 * 8 * 16 * 94.3 / 1e9,
)


@pytest.mark.parametrize("name", list(cs.PHASES))
def test_phase_tiny_on_cpu(name):
    cpu = jax.devices("cpu")[0]
    res = cs.PHASES[name](cpu, cpu, TINY)
    assert isinstance(res, dict) and res


def test_phase_f64_chunks_under_its_budget():
    cpu = jax.devices("cpu")[0]
    res = cs.phase_f64(cpu, cpu, TINY)
    assert res["default"]["auto_chunk"] is None  # the CPU reports no bytes_limit
    assert res["chunked"]["auto_chunk"] == 2
    assert res["chunked"]["rel_err_vs_cpu_f64"] == 0.0


@pytest.mark.parametrize(
    "argv, want",
    [([], ["gray", "clear", "allsky", "aerosky", "f64", "grad"]), (["--four"], ["mesh"])],
)
def test_phases_for(argv, want):
    assert cs.phases_for(argv) == want


def test_failing_phase_reports_and_returns_false(capsys, monkeypatch):
    def boom(dev, ref, sz):
        raise AssertionError("planted")

    monkeypatch.setitem(cs.PHASES, "gray", boom)
    cpu = jax.devices("cpu")[0]
    assert cs.run(["gray"], [cpu], cpu, TINY) is False
    out = capsys.readouterr().out
    assert '"ok": false' in out and "planted" in out


def _run(args, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_cpu(argv):
    """Without a GPU the script exits non-zero and prints no result."""
    r = _run([os.path.join(REPO, "chip_smoke.py"), *argv], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory (no package beside it) the script fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


_MESH = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
import chip_smoke as cs
sys.path.insert(0, {tests!r})
from test_chip_smoke import TINY
cpu = jax.devices("cpu")
assert len(cpu) == 4, cpu
assert cs.run(["mesh"], cpu, cpu[0], TINY, "cpu")
print("MESH-OK")
"""


def test_mesh_phase_on_four_virtual_devices():
    """--four's phase on a 4-device CPU mesh: sharded all-sky solve vs the
    per-shard solves with their global col_offset, cloud cover bitwise."""
    script = _MESH.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    r = _run(["-c", script], REPO,
             {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "MESH-OK" in r.stdout
    assert '"cloud_cover_bitwise": true' in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(cs.PHASES))
def test_phase_tiny_on_gpu(gpu_device, name):
    res = cs.PHASES[name](gpu_device, jax.devices("cpu")[0], TINY)
    assert isinstance(res, dict) and res
