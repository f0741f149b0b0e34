"""Rank processes for a mesh: start n processes that meet at one
``torch.distributed`` rendezvous and run the tasks a parent hands them.

``RankGroup(n)`` starts ``python -m
multi_cluster_simulator_tpu_torch.parallel.launch`` n times. Each child
joins a gloo group of n ranks through a ``FileStore`` in a fresh temporary
directory (no TCP port to pick), takes ``cuda:(rank % device_count)`` (or
the ``device`` the caller names; without a card and without a device the
group refuses to start, ``parallel.mesh.rank_device``), and
then serves tasks: ``group.run(k, fn, *args)`` sends ``fn`` (a module-level
function, pickled by reference) to every rank; each rank forms the mesh of
the first ``k`` ranks (``make_mesh(k)``, a collective over the world) and
the ranks inside it call ``fn(mesh, *args)``. ``run`` returns the results
of ranks ``0..k-1`` and raises, with the rank's traceback, where one
failed. Tasks and results cross on two pipes a rank, as pickles.

The children import only the module of ``fn`` and what it imports, so a
parent that has loaded other packages (a test process with JAX) does not
pass them on. ``close`` (or leaving the ``with`` block) stops every rank;
a rank also dies with its parent (``PR_SET_PDEATHSIG`` on Linux), so
killing the parent with SIGKILL leaves no rank running.

Run a function on n ranks once::

    with RankGroup(2, device="cpu") as g:
        results = g.run(2, mymodule.task, arg)
"""

from __future__ import annotations

import argparse
import os
import pickle
import select
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import traceback

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _send(fd: int, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    buf = struct.pack("<Q", len(data)) + data
    view = memoryview(buf)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _read_exact(fd: int, n: int, deadline=None) -> bytes:
    out = bytearray()
    while len(out) < n:
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                raise TimeoutError("rank did not answer in time")
        chunk = os.read(fd, min(n - len(out), 1 << 20))
        if not chunk:
            raise EOFError("rank process closed its pipe")
        out += chunk
    return bytes(out)


def _recv(fd: int, deadline=None):
    (n,) = struct.unpack("<Q", _read_exact(fd, 8, deadline))
    return pickle.loads(_read_exact(fd, n, deadline))


def _fn_ref(fn) -> tuple:
    """(module, qualified name) of a module-level function, the module of a
    ``__main__`` named as the children import it: its ``-m`` name, or a
    script's file name."""
    mod = fn.__module__
    if mod == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        mod = spec.name if spec is not None else os.path.splitext(
            os.path.basename(main.__file__))[0]
    return mod, fn.__qualname__


def _fn_of(ref: tuple):
    import importlib

    obj = importlib.import_module(ref[0])
    for part in ref[1].split("."):
        obj = getattr(obj, part)
    return obj


class RankGroup:
    """n rank processes of one gloo group, serving tasks (module
    docstring). ``device`` names every rank's device (None: the card by
    rank, and raises without one); ``env`` adds to the children's
    environment; ``timeout`` bounds each ``run`` in seconds and is the
    group's collective timeout. The rendezvous file lives in a fresh
    directory under ``store_dir`` (the temporary directory by default)."""

    def __init__(self, n: int, device=None, env=None, timeout: float = 600,
                 store_dir=None):
        from multi_cluster_simulator_tpu_torch.parallel.mesh import (
            rank_device,
        )

        rank_device(0, device)  # no card and no device: refuse here
        self.n, self.timeout = n, timeout
        self.dir = tempfile.mkdtemp(prefix="mcs-ranks-", dir=store_dir)
        store = os.path.join(self.dir, "store")
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT, os.getcwd()] + [p for p in child_env.get(
                "PYTHONPATH", "").split(os.pathsep) if p])
        child_env.setdefault("OMP_NUM_THREADS", "1")
        child_env.update(env or {})
        self.procs, self.task_w, self.res_r = [], [], []
        try:
            for r in range(n):
                t_r, t_w = os.pipe()
                r_r, r_w = os.pipe()
                cmd = [sys.executable, "-m", __name__, "--rank", str(r),
                       "--world", str(n), "--store", store,
                       "--fds", f"{t_r},{r_w}", "--timeout", str(timeout),
                       "--parent", str(os.getpid())]
                if device is not None:
                    cmd += ["--device", str(device)]
                self.procs.append(subprocess.Popen(
                    cmd, pass_fds=(t_r, r_w), env=child_env, cwd=os.getcwd()))
                os.close(t_r)
                os.close(r_w)
                self.task_w.append(t_w)
                self.res_r.append(r_r)
            deadline = time.monotonic() + timeout
            for r in range(n):  # every rank joined the group
                status, info = _recv(self.res_r[r], deadline)
                if status != "ready":
                    raise RuntimeError(f"rank {r} did not start:\n{info}")
        except BaseException:
            self.close()
            raise

    def run(self, k: int, fn, *args, **kwargs) -> list:
        """``fn(mesh, *args, **kwargs)`` on the mesh of ranks ``0..k-1``;
        their results in rank order."""
        if not 1 <= k <= self.n:
            raise ValueError(f"a mesh of {k} ranks in a group of {self.n}")
        task = (k, _fn_ref(fn), args, kwargs)
        for w in self.task_w:
            _send(w, task)
        deadline = time.monotonic() + self.timeout
        out, errors = [], []
        for r, fd in enumerate(self.res_r):
            status, value = _recv(fd, deadline)
            if status == "err":
                errors.append(f"rank {r}:\n{value}")
            elif r < k:
                out.append(value)
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        for w in self.task_w:
            try:
                _send(w, None)
                os.close(w)
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for fd in self.res_r:
            try:
                os.close(fd)
            except OSError:
                pass
        self.procs, self.task_w, self.res_r = [], [], []
        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _die_with_parent(parent: int) -> None:
    """SIGKILL this rank when its parent exits (Linux ``prctl``); exit now
    where the parent is already gone."""
    import ctypes
    import signal

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, int(signal.SIGKILL), 0, 0, 0)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _serve(args) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from multi_cluster_simulator_tpu_torch.parallel.mesh import make_mesh

    task_r, res_w = (int(x) for x in args.fds.split(","))
    if args.parent:
        _die_with_parent(args.parent)
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(args.store, args.world),
            rank=args.rank, world_size=args.world,
            timeout=datetime.timedelta(seconds=args.timeout))
    except BaseException:
        _send(res_w, ("err", traceback.format_exc()))
        raise
    _send(res_w, ("ready", None))
    try:
        while True:
            try:
                task = _recv(task_r)
            except EOFError:
                break
            if task is None:
                break
            k, ref, fargs, fkw = task
            try:
                mesh = make_mesh(k, device=args.device)
                value = _fn_of(ref)(mesh, *fargs, **fkw) if mesh.member \
                    else None
                _send(res_w, ("ok", value))
            except BaseException:
                _send(res_w, ("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--fds", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--parent", type=int, default=0)
    _serve(p.parse_args(argv))


if __name__ == "__main__":
    main()
