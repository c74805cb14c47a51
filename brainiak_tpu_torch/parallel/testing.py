"""Multi-process distributed test harness.

PyTorch counterpart of ``brainiak_tpu/parallel/testing.py``, the analog
of the reference's vendored pytest-mpiexec plugin: where the reference
re-executes tests under ``mpiexec -n N`` to exercise MPI collectives on
one machine, this harness launches N OS processes that form one
``torch.distributed`` process group over a local rendezvous, each
contributing ``local_devices`` CPU positions to the meshes it builds
(gloo), or its own CUDA card (NCCL, ``device="cuda"``).

Usage: write a worker function in an importable module with signature
``worker(process_id, num_processes)`` (it runs after
:func:`~brainiak_tpu_torch.parallel.mesh.initialize_distributed`) and
call :func:`run_distributed`.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ["run_distributed"]

#: the directory holding the ``brainiak_tpu_torch`` package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER_TEMPLATE = """
import os, pickle, sys
sys.path[:0] = [{extra_path!r}, {package_root!r}]
from brainiak_tpu_torch.parallel.mesh import initialize_distributed
initialize_distributed(coordinator_address="{coord}", num_processes={n},
                       process_id={pid}, backend={backend!r},
                       device="{device}", local_devices={local!r})
from {module} import {fn} as worker
try:
    result = worker({pid}, {n})
except BaseException:
    import traceback
    traceback.print_exc(file=sys.stderr)
    sys.stderr.flush()
    # skip atexit: the process group's shutdown would block on peers
    # that are themselves blocked in a collective waiting for this one
    os._exit(1)
with open({out!r}, "wb") as f:
    pickle.dump(result, f)
# every rank reaches here before any leaves, so no peer loses a
# message still in flight when this process exits
import torch.distributed
torch.distributed.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_distributed(module, fn, n_procs=2, local_devices=2, timeout=240,
                    extra_path=None, device="cpu", backend=None):
    """Run ``module.fn(process_id, num_processes)`` in ``n_procs`` OS
    processes forming one ``torch.distributed`` process group.

    With ``device="cpu"`` (gloo) each process contributes
    ``local_devices`` CPU positions to a mesh built with
    ``devices=None``, so the global position count is ``n_procs *
    local_devices``; with ``device="cuda"`` (NCCL) each process takes
    one card (``local_devices`` is ignored).  ``backend`` is that of
    :func:`~brainiak_tpu_torch.parallel.mesh.initialize_distributed`
    (None: NCCL for ``"cuda"``, gloo for ``"cpu"``); ``device="cuda",
    backend="gloo"`` runs the ranks on the card ``cuda:(rank %
    device_count)`` each, so two ranks share one card, their
    collectives staged through the host (NCCL refuses two ranks on one
    device).  The moment a process
    fails, the others are killed and its output's tail is raised as a
    ``RuntimeError``; a run past ``timeout`` seconds is killed and
    raises too.  Returns the list of per-process return values (which
    must be picklable).
    """
    coord = f"127.0.0.1:{_free_port()}"
    if extra_path is None:
        extra_path = os.getcwd()
    local = ["cpu"] * local_devices if device == "cpu" else None
    procs = []
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for pid in range(n_procs):
            out = os.path.join(tmp, f"result_{pid}.pkl")
            outs.append(out)
            code = _WORKER_TEMPLATE.format(
                coord=coord, n=n_procs, pid=pid, module=module, fn=fn,
                out=out, device=device, backend=backend, local=local,
                extra_path=extra_path, package_root=_PACKAGE_ROOT)
            env = dict(os.environ)
            env.pop("PYTHONPATH", None)
            if device == "cpu":
                # the processes share the host's cores
                env["OMP_NUM_THREADS"] = "1"
            # output to files: pipes would fill and deadlock verbose
            # workers, since the poll loop does not drain them
            err_path = os.path.join(tmp, f"stderr_{pid}.log")
            err_f = open(err_path, "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=err_f, stderr=err_f), err_path, err_f))
        # poll: the moment any worker dies with an error, kill the
        # rest, which would otherwise hang in a collective to timeout
        deadline = time.monotonic() + timeout
        errors = []
        timed_out = False
        while True:
            rcs = [p.poll() for p, _, _ in procs]
            failed = [pid for pid, rc in enumerate(rcs)
                      if rc is not None and rc != 0]
            if failed or all(rc is not None for rc in rcs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.1)
        killed = set()
        for pid, (p, _, _) in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(pid)
        if timed_out:
            errors.append(f"distributed run timed out after {timeout}s")
        for pid, (p, err_path, err_f) in enumerate(procs):
            p.wait()
            err_f.close()
            if p.returncode != 0 and pid not in killed:
                with open(err_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                errors.append(
                    f"process {pid} failed (rc={p.returncode}):\n"
                    f"{tail}")
        if errors:
            raise RuntimeError("\n".join(errors))
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    return results
