"""Multi-host dispatch of ctts_tpu_torch (parallel/multihost.py) on the
CPU: two spawned worker processes join a gloo group, each serves its
block of the texts of tests/test_multihost.py:50-52 with a [cpu] * 2
mesh, and the outputs are exchanged.

(a) process 0's gathered outputs equal one process's unsplit output bit
    for bit and stay within 2 LSB of the oracle; `return_local` matches
    the gathered rows; the exchange is a meta round (int64), the int32
    lengths and the int16 samples as their bytes (uint8); neither jax
    nor ctts_tpu is loaded in a worker;
(b) local_slice agrees with the JAX package's on a grid of (n, P, p);
(c) a rendezvous nobody serves raises.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ctts_tpu.config import config_defaults
from ctts_tpu.db.reader import VoiceDatabase
from ctts_tpu.plan.compiler import compile_plan
from ctts_tpu.synth.oracle import execute_plan_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_multihost.py:50-52: process 0's block holds the long
# paragraph, so the flat exchange pads to the larger process total.
TEXTS = ["bom dia. que legal ver a rosa e o rato no mato de manhã.",
         "bom dia", "que legal", "a rosa",
         "vamos", "sim claro", "oi", "nada"]

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

coordinator, pid, dbp, outp = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                               sys.argv[4])
texts = sys.argv[5:]
torch.set_num_threads(2)

from ctts_tpu_torch.config import config_defaults
from ctts_tpu_torch.db.reader import VoiceDatabase
from ctts_tpu_torch.parallel import BatchSynthesizer, make_mesh
from ctts_tpu_torch.parallel.multihost import (
    initialize, synthesize_across_hosts)

initialize(coordinator, 2, pid, timeout_s=240)
assert dist.get_world_size() == 2 and dist.get_rank() == pid

gathered = []
all_gather = dist.all_gather
def recording(parts, t, *args, **kwargs):
    gathered.append(str(t.dtype))
    return all_gather(parts, t, *args, **kwargs)
dist.all_gather = recording

bs = BatchSynthesizer(VoiceDatabase(dbp), config_defaults(),
                      mesh=make_mesh([torch.device("cpu")] * 2))
outs = synthesize_across_hosts(bs, texts)
assert len(outs) == len(texts)
assert gathered == ["torch.int64", "torch.int32", "torch.uint8"], gathered

idx, local = synthesize_across_hosts(bs, texts, return_local=True)
assert 0 < len(idx) < len(texts)
for i, o in zip(idx, local):
    assert np.array_equal(o, outs[i]), i
assert len(gathered) == 3     # return_local exchanges nothing

loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "ctts_tpu" or m.startswith("ctts_tpu."))
assert not loaded, loaded
if pid == 0:
    np.savez(outp, **{str(i): o for i, o in enumerate(outs)})
dist.destroy_process_group()
print(f"proc {pid} OK", flush=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in six workers on a few cores: a small intra-op
    pool keeps torch's many small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_dispatch(voice_db, tmp_path):
    from ctts_tpu_torch.config import config_defaults as t_config
    from ctts_tpu_torch.db.reader import VoiceDatabase as TDB
    from ctts_tpu_torch.parallel.batch import BatchSynthesizer

    coordinator = f"127.0.0.1:{_free_port()}"
    outp = str(tmp_path / "mh_out.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, coordinator, str(pid), voice_db,
         outp] + TEXTS, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    data = np.load(outp)
    want = BatchSynthesizer(TDB(voice_db), t_config(),
                            device=torch.device("cpu")).synthesize(TEXTS)
    db = VoiceDatabase(voice_db)
    for i, t in enumerate(TEXTS):
        got = data[str(i)]
        assert got.dtype == np.int16 and np.array_equal(got, want[i]), t
        ref = execute_plan_oracle(
            compile_plan(db, t, config_defaults(), None, 1.0), db)
        assert ref.shape == got.shape, t
        assert np.abs(ref.astype(np.int32)
                      - got.astype(np.int32)).max() <= 2, t


def test_local_slice_matches_jax():
    from ctts_tpu.parallel.multihost import local_slice as jax_slice
    from ctts_tpu_torch.parallel.multihost import local_slice

    for n in range(0, 40):
        for nproc in range(1, 9):
            blocks = [local_slice(n, nproc, p) for p in range(nproc)]
            assert blocks == [jax_slice(n, nproc, p) for p in range(nproc)]
            assert [i for b in blocks for i in b] == list(range(n))


def test_failed_rendezvous_raises():
    import torch.distributed as dist

    from ctts_tpu_torch.parallel.multihost import initialize

    with pytest.raises(RuntimeError):
        initialize(f"127.0.0.1:{_free_port()}", 2, 1, timeout_s=2)
    assert not dist.is_initialized()
