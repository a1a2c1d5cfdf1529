"""Multi-card LWS: data-parallel batching and time-sharded sweeps.

The port's version of examples/multichip.py, on lws_torch.parallel
(torch.distributed, one process per rank):

    python -m lws_torch.examples.multichip --ranks 4 [--device cpu]
    torchrun --nproc-per-node 4 -m lws_torch.examples.multichip

Without torchrun it spawns --ranks ranks (default 4) that join one process
group: NCCL when each rank has a card of its own, gloo when they share one
card or run on the CPU (gloo stages the halos through host memory, so the
times of ranks that share a card are no scaling figure). Under torchrun it
spawns nothing, --ranks, if given, must equal the world size, and the group
is `init_distributed`'s: NCCL on CUDA (it raises when the ranks on a host
outnumber its cards: run those without torchrun), gloo with --device cpu.

Utterance batches split over the 'data' mesh axis (LWS has no traffic
between items), and long spectrograms split their frames over 'time' for the
batch sweeps, with a (Q-1)-frame halo exchange between time neighbours per
sweep. The mesh is (2, n // 2) for an even n >= 4, else (1, n)
(`parallel.multihost.mesh_shape`).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

import lws_torch
from lws_torch._device import resolve_device
from lws_torch.parallel import data_parallel_run, init_distributed, make_mesh
from lws_torch.parallel.multihost import mesh_shape, spawn_ranks
from lws_torch.parallel.sharding import gather_pair

SAMPLE_RATE = 16000


def tones(count, seconds, rng):
    """`count` utterances of `seconds` at SAMPLE_RATE: a tone of 100 + 30 i
    Hz plus white noise at 0.1 (examples/multichip.py's batch), (count, n)."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    return np.stack([np.sin(2 * np.pi * (100 + 30 * i) * t) + 0.1 * rng.standard_normal(t.size)
                     for i in range(count)])


def run(mesh, utterances=4, seconds=3.0, frames=256):
    """The example's two stages on this rank of `mesh` (every rank of the
    default group calls it); rank 0 prints one line per stage. Returns the
    numbers: stage 1, `utterances` per 'data' rank of `seconds` each through
    `run_lws`, data-parallel; stage 2, (data, frames per 'time' rank, 257)
    through `batch_lws(mesh=)`."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, time = mesh.shape["data"], mesh.shape["time"]
    if rank == 0:
        backend = dist.get_backend() if dist.is_initialized() else "none"
        print(f"ranks: {dist.get_world_size() if dist.is_initialized() else 1} on "
              f"{mesh.device.type} ({backend}), mesh: data={data} x time={time}", flush=True)
    proc = lws_torch.LWS(512, 128, mode="music", batch_iterations=50, device=mesh.device)

    # --- 1. data-parallel: a batch of utterances, split over 'data' ---------
    rng = np.random.default_rng(0)
    batch = tones(utterances * data, seconds, rng)
    sr, si = proc.stft_ri(batch)  # (sr, si) planes on the device
    amp = torch.sqrt(sr * sr + si * si)
    pair = (amp, torch.zeros_like(amp))
    out = data_parallel_run(lambda r, i: proc.run_lws((r, i)), pair, mesh)
    out = gather_pair(out, mesh, time_sharded=False)  # every rank's utterances, on every rank
    cons = proc.get_consistency(out).cpu().numpy()
    cons_in = proc.get_consistency(pair).cpu().numpy()
    mag = torch.sqrt(out[0] * out[0] + out[1] * out[1])
    mag_err = float(((mag - amp).abs() / amp.clamp_min(1e-30)).max())
    if rank == 0:
        print(f"data-parallel run_lws: {batch.shape[0]} utterances, consistency "
              f"{cons.mean():.2f} dB (|X| {cons_in.mean():.2f} dB; per-rank batch "
              f"{utterances})", flush=True)

    # --- 2. time-sharded: one long spectrogram over the 'time' axis ---------
    T = frames * time
    long_amp = np.abs(rng.standard_normal((data, T, 257))).astype(np.float32)
    S = proc.batch_lws((long_amp, np.zeros_like(long_amp)), mesh=mesh)
    c_long = float(proc.get_consistency(S)[0])
    if rank == 0:
        print(f"time-sharded batch_lws: T={T} frames over {time} shards (halo exchange per "
              f"sweep), consistency {c_long:.2f} dB", flush=True)
    return dict(mesh=[data, time], utterances=int(batch.shape[0]), consistency=cons.tolist(),
                consistency_in=cons_in.tolist(), magnitude_err=mag_err,
                long_shape=[data, T, 257], long_consistency=c_long)


def _mesh(n, device):
    return make_mesh(*mesh_shape(n), device=device)


def _spawned(device, n):
    return run(_mesh(n, device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: the world size under torchrun, else 4)")
    ap.add_argument("--device", default=None, help="torch device type (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun: one rank per process
        cuda = dev.type == "cuda"
        init_distributed(backend=None if cuda else "gloo")
        n = dist.get_world_size()
        if args.ranks not in (None, n):
            raise SystemExit(f"--ranks {args.ranks} under torchrun with {n} ranks")
        try:
            run(_mesh(n, "cuda" if cuda else dev))
        finally:
            dist.destroy_process_group()
        return
    n = args.ranks or 4
    spawn_ranks(n, dev, _spawned, n)


if __name__ == "__main__":
    main()
