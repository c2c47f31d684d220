"""tvts_torch/cli/dryrun.py, the twin of __graft_entry__.py, on the CPU:
- `python -m tvts_torch.cli.dryrun 4` (dp 1 x sp 2 x tp 2 over four gloo
  processes, the JAX dry run's factors) and `8` (fsdp 2 x sp 2 x tp 2) exit
  0, every rank printing its eager (tokens split over sp) and kernel-path
  (tokens whole) losses within 1e-4 of each other, and no rank loads JAX;
- `entry()`'s B/16 forward gives the JAX entry's output shapes (on the meta
  device: the full-width forward's shapes without its CPU cost);
- the dp 2 x fsdp 2 (HSDP) step's gradient is the whole batch's: an
  SGD(lr=1) delta on four ranks against one process, within 2e-5 of each
  tensor's largest delta (FSDP2 averages over both axes).
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4

HSDP_WORKER = r"""
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
from tvts_torch.cli.dryrun import _batch, tiny_config
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.parallel.mesh import create_mesh
from tvts_torch.parallel.partition import full_state_dict, shard_batch, shard_params
from tvts_torch.train.optim import OptimizerConfig
from tvts_torch.train.step import make_train_step

cfg = tiny_config()
batch = {k: torch.from_numpy(a) for k, a in _batch(cfg, 2 * n, 0).items()}

def sgd_delta(mesh=None):
    # seeded noise on every leaf: at init the time attention is zero and its
    # gradient is all rounding
    model = TVTSv2(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    init = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
            for k, v in model.state_dict().items()}
    model.load_state_dict(init)
    part = batch
    if mesh is not None:
        shard_params(model, mesh)
        part = shard_batch(batch, mesh)
    sgd = torch.optim.SGD([{"params": list(model.parameters()), "lr": 1.0, "base_lr": 1.0}])
    make_train_step(model, sgd, OptimizerConfig(), mesh=mesh)(part)
    return {k: (v - init[k]).numpy() for k, v in full_state_dict(model).items()}

with create_mesh(fsdp=2, coordinator=f"localhost:{port}", num_processes=n, process_id=rank,
                 device="cpu") as mesh:
    got = sgd_delta(mesh)
if rank == 0:
    np.savez(os.path.join(work, "hsdp.npz"), **got)
    np.savez(os.path.join(work, "one.npz"), **sgd_delta())
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(commands: list, work) -> list:
    """Start one process a command, its output to a file in `work`; returns
    [(process, log path)] for wait_ranks."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    started = []
    for r, cmd in enumerate(commands):
        path = work / f"rank{r}.log"
        with open(path, "w") as out:
            started.append((subprocess.Popen(cmd, env=env, cwd=REPO, stdout=out,
                                             stderr=subprocess.STDOUT), path))
    return started


def wait_ranks(started: list, timeout: float) -> list:
    """Wait for start_ranks' processes; stop them all once one fails or the
    time runs out, as the others would wait in a collective. Returns each
    one's (exit code, output)."""
    procs = [p for p, _ in started]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline \
                and not any(p.poll() for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, path.read_text()) for p, path in started]


def run_ranks(commands: list, work, timeout: float) -> list:
    """Run one process a command (wait_ranks' results)."""
    return wait_ranks(start_ranks(commands, work), timeout)


def _dryrun(n: int) -> str:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "tvts_torch.cli.dryrun", str(n)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def dryrun_log():
    return _dryrun(N)


def _check_dryrun(log: str, n: int, axes: str) -> None:
    rows = re.findall(r"\[dryrun rank (\d)\] " + axes + r": eager loss (\S+), kernel path "
                      r"loss (\S+); modules of JAX loaded: \[\]", log)
    assert sorted(int(r) for r, _, _ in rows) == list(range(n)), log
    for _, eager, kernels in rows:
        assert np.isfinite(float(eager)) and abs(float(eager) - float(kernels)) <= 1e-4
    assert len({(e, k) for _, e, k in rows}) == 1  # every rank the whole batch's loss
    assert f"dryrun_multichip OK ({n} processes)" in log


def test_dryrun_4_exits_0_with_both_losses_close(dryrun_log):
    _check_dryrun(dryrun_log, N, "dp 1 x fsdp 1 x sp 2 x tp 2")


def test_dryrun_8_takes_the_jax_factors():
    _check_dryrun(_dryrun(8), 8, "dp 1 x fsdp 2 x sp 2 x tp 2")


def test_entry_gives_the_b16_forward_shapes():
    from tvts_torch.cli.dryrun import entry

    fn, args = entry("meta")
    with torch.no_grad():
        text_emb, video_emb, predict_order = fn(*args)
    assert [tuple(t.shape) for t in (text_emb, video_emb, predict_order)] == \
        [(2, 512), (2, 512), (2, 4, 4)]
    assert text_emb.dtype == torch.bfloat16
    assert args[0].shape == (2, 12, 3, 224, 224) and args[2].shape == (2, 98)


def test_hsdp_step_is_the_whole_batch_gradient(tmp_path):
    (tmp_path / "worker.py").write_text(HSDP_WORKER)
    port = str(_free_port())
    for rc, log in run_ranks([[sys.executable, str(tmp_path / "worker.py"), str(r), str(N), port,
                               str(tmp_path)] for r in range(N)], tmp_path, timeout=300):
        assert rc == 0, log[-4000:]
    got, want = np.load(tmp_path / "hsdp.npz"), np.load(tmp_path / "one.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-5 * scale + 1e-7,
                                   err_msg=key)
