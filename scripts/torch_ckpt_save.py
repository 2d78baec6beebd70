#!/usr/bin/env python3
"""Where the time of a checkpoint save goes, on one CUDA card: the stages
of ``train/checkpoint.py``'s save, each timed on its own, beside a raw
write of the same bytes to the same filesystem.

    python3 scripts/torch_ckpt_save.py [--whole-only]

Imports ``kubeflow_tpu_torch`` from the checkout that holds the script
(to compare two trees, run a copy of it from each). Builds the train
state of Llama-3-8B at full width with ``LAYERS`` = 2 layers (17.84 GB of
fp32 params and Adam moments, the state ``chip_smoke.py``'s
crash-and-resume pair saves) on the card, then times:

- ``d2h_pageable``: every tensor leaf copied to host memory with
  ``.to("cpu")``, one leaf at a time;
- ``pin_alloc`` and ``d2h_pinned``: page-locked host buffers allocated
  (``pin_memory=True``, one per leaf), then every leaf copied into them
  with ``non_blocking=True`` and one synchronisation; ``pin_register``:
  one pageable buffer of the state's bytes allocated, touched and
  page-locked with ``cudaHostRegister`` instead; the host memory each
  takes (``MemAvailable``'s drop);
- ``serialize``: ``torch.save`` of each host leaf into memory;
- ``write_torch_save``: those bytes written to one file per leaf;
- ``sha256_1`` and ``sha256_N``: the manifest's SHA-256 read-back of
  those files, on one thread and on ``THREADS`` = 8 (the manager's);
- ``write_raw_1`` and ``write_raw_N``: the raw bytes of the pinned
  buffers written to one file per leaf, on one thread and on
  ``THREADS``: the floor a save cannot beat;
- ``sync``: after each writing stage, ``os.sync()``, timed apart;
- ``manager_save``: ``CheckpointManager.save`` of the whole state from
  the call to its return, and ``manager_commit`` to the step committed
  (``wait()``; the same instant where the checkout's save is
  synchronous), with the host memory the save holds and, where the
  checkout's manager records them, its files' written-and-hashed time.

``--whole-only`` times only the manager's save (to compare two trees:
run their copies alternately, A, B, B, A). Files go to a git-ignored
``.torch_ckpt_save_*`` directory of the checkout and are removed after
each stage. Prints the host's memory and the directory's
filesystem, then one JSON line of seconds and GB/s.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[1]
LAYERS = 2
THREADS = 8


def meminfo() -> dict:
    """MemTotal, MemAvailable and Dirty from /proc/meminfo, in GB."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable", "Dirty"):
                out[key] = int(val.split()[0]) * 1024 / 1e9
    return out


def mount_of(path: str) -> str:
    """The mount point, type and source that hold ``path``."""
    best = ("", "", "")
    with open("/proc/mounts") as f:
        for line in f:
            src, mnt, kind = line.split()[:3]
            if path.startswith(mnt) and len(mnt) > len(best[0]):
                best = (mnt, kind, src)
    st = os.statvfs(path)
    return (f"{best[0]} ({best[1]}, {best[2]}), "
            f"{st.f_bavail * st.f_frsize / 1e9:.1f} GB free")


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def run_pool(fn, items, threads: int) -> None:
    if threads == 1:
        for it in items:
            fn(it)
        return
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(fn, it) for it in items]:
            f.result()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--whole-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(TREE))

    import torch

    if not torch.cuda.is_available():
        print("torch_ckpt_save: no CUDA device", file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.models.config import preset
    from kubeflow_tpu_torch.train import tree as T
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager, _sha256
    from kubeflow_tpu_torch.train.optim import OptimizerConfig
    from kubeflow_tpu_torch.train.step import setup_train

    cfg = preset("llama3-8b", n_layers=LAYERS)
    state = setup_train(cfg, OptimizerConfig(), device="cuda",
                        seed=0).state
    leaves = {p: t for p, t in T.flatten(state).items()
              if isinstance(t, torch.Tensor)}
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    torch.cuda.synchronize()
    work = tempfile.mkdtemp(prefix=".torch_ckpt_save_", dir=TREE)
    print(f"torch_ckpt_save: {torch.cuda.get_device_name(0)}, tree {TREE}, "
          f"{len(leaves)} tensor leaves, {nbytes / 1e9:.2f} GB; host "
          + json.dumps({k: round(v, 2) for k, v in meminfo().items()})
          + f"; {os.cpu_count()} CPUs; {work} on {mount_of(work)}",
          flush=True)
    secs: dict[str, float] = {}

    def sync(stage: str) -> None:
        secs[f"sync_after_{stage}"] = timed(os.sync)

    try:
        if not args.whole_only:
            host = {}

            def pageable():
                for p, t in leaves.items():
                    host[p] = t.detach().to("cpu")

            secs["d2h_pageable"] = timed(pageable)
            pinned = {}

            def alloc():
                for p, t in leaves.items():
                    pinned[p] = torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)

            avail = meminfo()["MemAvailable"]
            secs["pin_alloc"] = timed(alloc)
            host_gb = {"pin_alloc": avail - meminfo()["MemAvailable"]}

            def copy_pinned():
                for p, t in leaves.items():
                    pinned[p].copy_(t.detach(), non_blocking=True)
                torch.cuda.synchronize()

            secs["d2h_pinned"] = timed(copy_pinned)
            same = all(torch.equal(host[p], pinned[p]) for p in leaves)
            serial, wrote = 0.0, 0.0
            files = []
            for p, h in host.items():
                buf = io.BytesIO()
                serial += timed(lambda: torch.save(h, buf))
                path = os.path.join(work, p.replace("/", ".") + ".pt")

                def write():
                    with open(path, "wb") as f:
                        f.write(buf.getbuffer())

                wrote += timed(write)
                files.append(path)
                del buf
            secs["serialize"], secs["write_torch_save"] = serial, wrote
            sync("write_torch_save")
            secs["sha256_1"] = timed(lambda: run_pool(_sha256, files, 1))
            secs[f"sha256_{THREADS}"] = timed(
                lambda: run_pool(_sha256, files, THREADS))
            del host
            shutil.rmtree(work)
            os.makedirs(work)

            def raw(p):
                path = os.path.join(work, p.replace("/", ".") + ".bin")
                with open(path, "wb") as f:
                    f.write(memoryview(
                        pinned[p].reshape(-1).view(torch.uint8).numpy()))

            for threads in (1, THREADS):
                secs[f"write_raw_{threads}"] = timed(
                    lambda: run_pool(raw, list(pinned), threads))
                sync(f"write_raw_{threads}")
                shutil.rmtree(work)
                os.makedirs(work)
            del pinned
            avail = meminfo()["MemAvailable"]
            flat = torch.empty(nbytes, dtype=torch.uint8)

            def register():
                flat.fill_(0)
                rc = torch.cuda.cudart().cudaHostRegister(
                    flat.data_ptr(), nbytes, 0)
                host_gb["pin_register_rc"] = int(rc)

            host_gb = {**host_gb}
            secs["pin_register"] = timed(register)
            host_gb["pin_register"] = avail - meminfo()["MemAvailable"]
            torch.cuda.cudart().cudaHostUnregister(flat.data_ptr())
            del flat
            print(f"torch_ckpt_save: pinned and pageable copies equal: "
                  f"{same}; host GB taken: " + json.dumps(host_gb),
                  flush=True)
        mgr = CheckpointManager(os.path.join(work, "ckpt"))
        avail = meminfo()["MemAvailable"]
        t0 = time.perf_counter()
        mgr.save(1, state)
        secs["manager_save"] = time.perf_counter() - t0
        taken = avail - meminfo()["MemAvailable"]
        mgr.wait()  # blocking-ok: the script times the save to its commit
        secs["manager_commit"] = time.perf_counter() - t0
        times = getattr(mgr, "last_save", {})
        if "written" in times:
            secs["manager_written"] = times["written"] - times["called"]
        mgr.close()
        print(f"torch_ckpt_save: the save's snapshot took {taken:.2f} GB "
              f"of host memory", flush=True)
        on_disk = sum(os.path.getsize(os.path.join(b, f))
                      for b, _, fs in os.walk(os.path.join(work, "ckpt"))
                      for f in fs)
        sync("manager_save")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rates = {k: nbytes / v / 1e9 for k, v in secs.items()
             if not k.startswith("sync") and v > 0}
    print(json.dumps({"tree": str(TREE), "card":
                      torch.cuda.get_device_name(0), "gb": nbytes / 1e9,
                      "on_disk_gb": on_disk / 1e9, "seconds": secs,
                      "gb_per_s": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
