"""Multi-host batch dispatch over torch.distributed.

Counterpart of ctts_tpu/parallel/multihost.py:29-116. Synthesis is
independent per sentence, so multi-host serving is plain data dispatch:
each process lowers and synthesizes its block of the texts on its own
devices (a BatchSynthesizer over the local mesh, or over one device), and
the only exchange between processes is the final all-gather of the
output lengths and samples for whoever writes the audio. The outputs are
on the host after the drain, so the exchange runs on the `gloo` backend
over host tensors.

`initialize()` joins the process group; `synthesize_across_hosts()`
splits the texts into contiguous blocks, one per process, and
all-gathers the outputs so that every process returns the whole batch
(or, with `return_local`, only its own block, with no exchange).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str, num_processes: int, process_id: int,
               timeout_s: float = 300.0) -> None:
    """Join the gloo process group whose rendezvous is `coordinator`
    ("host:port", served by process 0). A rendezvous that fails or takes
    longer than `timeout_s` raises.

    JAX's `local_device_count` (the count of virtual CPU devices a
    process gets) has no counterpart: the caller builds its local mesh
    (parallel/mesh.py make_mesh) and the BatchSynthesizer over it."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))


def local_slice(n_items: int, num_processes: int, process_id: int) -> range:
    """Contiguous block partition of [0, n_items) for this process."""
    base = n_items // num_processes
    extra = n_items % num_processes
    start = process_id * base + min(process_id, extra)
    return range(start, start + base + (1 if process_id < extra else 0))


def _all_gather(t: torch.Tensor) -> list:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return parts


def synthesize_across_hosts(batcher, texts: Sequence[str],
                            speed: float = 1.0,
                            return_local: bool = False):
    """Synthesize `texts` across all processes of the group.

    `batcher` is a BatchSynthesizer over this process's devices. By
    default the outputs are exchanged so that every process returns the
    whole batch in input order. With `return_local=True` there is no
    exchange: returns `(indices, outputs)` of this process's block.

    The exchange packs each process's outputs into one flat int16 buffer
    (the valid samples back to back), padded only to the largest process
    total, so the all-gather moves O(total audio) bytes: a meta round of
    [count, total] (int64), one all-gather of the int32 lengths, and one
    of the flat buffer. gloo refuses int16 tensors, so the buffer goes as
    its bytes (uint8, 2 a sample) and is viewed back as int16."""
    nproc = dist.get_world_size()
    mine = local_slice(len(texts), nproc, dist.get_rank())
    outs = batcher.synthesize([texts[i] for i in mine], speed=speed)
    if return_local:
        return list(mine), outs

    meta = torch.stack(_all_gather(torch.tensor(
        [len(outs), sum(int(o.shape[0]) for o in outs)], dtype=torch.int64)))
    max_count = int(meta[:, 0].max())
    max_total = int(meta[:, 1].max())

    lens = np.zeros(max(max_count, 1), np.int32)
    flat = np.zeros(max(max_total, 1), np.int16)
    off = 0
    for j, o in enumerate(outs):
        lens[j] = o.shape[0]
        flat[off:off + o.shape[0]] = o
        off += o.shape[0]
    all_lens = _all_gather(torch.from_numpy(lens))
    all_flat = _all_gather(torch.from_numpy(flat).view(torch.uint8))

    results = [None] * len(texts)
    for p in range(nproc):
        samples = all_flat[p].numpy().view(np.int16)
        off = 0
        for j, i in enumerate(local_slice(len(texts), nproc, p)):
            ln = int(all_lens[p][j])
            results[i] = samples[off:off + ln]
            off += ln
    return results
