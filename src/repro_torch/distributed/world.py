"""A world of processes, one a rank, started from one process (the
tests, ``chip_smoke.py``), and the serving and training rank bodies they
run.

:func:`run_world` spawns ``world_size`` processes, gives them a
``torch.distributed`` default group through a file store (no network:
the store is a file in a temporary directory) on the backend the caller
names, runs the same list of calls in every rank and returns each rank's
results.  A world that does not finish within ``timeout_s`` is killed
and raises, so a rank that stalls a collective fails its caller instead
of hanging it.

Two ranks cannot share one card under NCCL; ``gloo`` takes CUDA tensors
(through host memory), so a world of ranks on one H100 names ``gloo``.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import DEFAULT_DEVICE

#: one call of every rank: ``fn(*args)``, where ``fn`` is importable by
#: name in a fresh process (a module-level function) and ``args`` a tuple
#: every rank takes, or a list of tuples, rank ``r`` taking the ``r``-th
Call = Tuple[Callable, Union[tuple, List[tuple]]]


def _rank_main(rank: int, world_size: int, backend: str, tmp: str,
               timeout_s: float) -> None:
    # one intra-op thread a rank: the ranks' host work is small, and
    # threads that spin while a collective waits would starve the others
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"),
                                          world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            calls = torch.load(os.path.join(tmp, "calls.pt"),
                               weights_only=False)
            result = ("ok", [fn(*(args[rank] if isinstance(args, list)
                                  else args)) for fn, args in calls])
        finally:
            dist.destroy_process_group()
    except Exception:          # reported to the parent, which raises it
        result = ("error", traceback.format_exc())
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


def run_world(world_size: int, calls: Sequence[Call], *, backend: str,
              timeout_s: float = 600.0) -> List[List[Any]]:
    """Run ``calls`` in order in every rank of a new world of
    ``world_size`` processes over ``backend`` (``"gloo"`` or ``"nccl"``:
    named by the caller, never guessed).  Returns ``results[rank][i]``,
    the value of call ``i`` in rank ``rank``.  Raises ``RuntimeError``
    with the rank's traceback if a rank fails (the other ranks are
    killed), ``TimeoutError`` if the world outlives ``timeout_s``."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tp_world_") as tmp:
        torch.save(list(calls), os.path.join(tmp, "calls.pt"))
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                             args=(r, world_size, backend, tmp, timeout_s))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            results = _collect(procs, outs, time.monotonic() + timeout_s,
                               timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return results


def _collect(procs, outs, deadline: float, timeout_s: float):
    """Wait for every rank; the first failure or the deadline ends the
    world."""
    done = {}
    while len(done) < len(procs):
        for r, p in enumerate(procs):
            if r in done or p.is_alive():
                continue
            if not os.path.exists(outs[r]):
                raise RuntimeError(f"tp rank {r} exited with code "
                                   f"{p.exitcode} and no result")
            status, value = torch.load(outs[r], weights_only=False)
            if status != "ok":
                raise RuntimeError(f"tp rank {r} failed:\n{value}")
            done[r] = value
        if len(done) < len(procs):
            if time.monotonic() > deadline:
                late = [r for r in range(len(procs)) if r not in done]
                raise TimeoutError(f"tp ranks {late} did not finish within "
                                   f"{timeout_s} s")
            time.sleep(0.05)
    return [done[r] for r in range(len(procs))]


def serve_replay(model, runs: Sequence[dict], device: str = DEFAULT_DEVICE
                 ) -> List[dict]:
    """The serving rank body: for each run, a ``ServingEngine`` with
    ``tp`` = the world's size over the default group, or, where
    ``run["groups"]`` splits the world's ranks into lists, ``tp`` = the
    size of this rank's list over a group of those ranks
    (``run["engine"]``: its other arguments), driven by
    ``run["actions"]``, in order:

      * ``("submit", prompt, max_new[, temperature])``: a new request;
      * ``("step",)`` / ``("run",)``: ``step()`` / ``run_until_done()``;
      * ``("preempt", i)``: preempt request ``i``'s session;
      * ``("mark",)``: record the prefix-cache hits and copy-on-write
        copies so far.

    ``model``: ``(qparams, plans, cfg)``, the full parameters every rank
    starts from.  Returns, a run, the requests' token streams,
    ``describe()["tp"]``, ``describe_str()``, ``fold_wo`` and the marks;
    a paged run's allocator is checked at its end."""
    from repro_torch.serving import Request, ServingEngine
    qparams, plans, cfg = model
    out = []
    for run in runs:
        group, tp = None, dist.get_world_size()
        for ranks in run.get("groups", ()):
            # every rank of the world takes part in making every group
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                group, tp = g, len(ranks)
        eng = ServingEngine(qparams, plans, cfg, tp=tp, device=device,
                            group=group, **run["engine"])
        reqs, sessions, marks = [], [], []
        for op, *arg in run["actions"]:
            if op == "submit":
                reqs.append(Request(uid=len(reqs), prompt=list(arg[0]),
                                    max_new_tokens=arg[1],
                                    temperature=arg[2] if len(arg) > 2
                                    else 0.0))
                sessions.append(eng.submit(reqs[-1]))
            elif op == "step":
                eng.step()
            elif op == "run":
                eng.run_until_done()
            elif op == "preempt":
                eng.preempt(sessions[arg[0]])
            elif op == "mark":
                c = eng.describe()["cache"]
                marks.append((c["prefix"]["hits"], c["cow_copies"]))
            else:
                raise ValueError(f"unknown action {op!r}")
        if eng.paged:
            eng.kv.allocator.check()
        out.append({"streams": [list(r.out_tokens) for r in reqs],
                    "tp": eng.describe()["tp"],
                    "describe": eng.describe_str(), "fold_wo": eng.fold_wo,
                    "marks": marks})
    return out


def train_replay(cfg, params, batches, *, mesh_shape, opt_cfg,
                 fsdp: bool = False, accum_steps: int = 1, qat: bool = True,
                 device: str = DEFAULT_DEVICE) -> dict:
    """The training rank body: a ``(data, model)`` mesh of ``mesh_shape``
    on the default group, the rank's blocks of ``params`` (the whole
    float tree, on any device) under ``param_pspecs(params, mesh,
    fsdp)``, moments from ``adamw_init`` (ZeRO-1 slices where
    ``opt_cfg.zero1``), then one ``make_train_step`` step a global batch
    of ``batches``.  Returns the metrics of each step (floats) and the
    whole params and moments after the last step (CPU tensors; every
    rank gathers them)."""
    from repro_torch.core.treepath import tree_map
    from repro_torch.launch import shardings as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import moment_specs
    mesh = make_mesh(mesh_shape, ("data", "model"))
    specs = shd.param_pspecs(params, mesh, fsdp=fsdp)
    local = tree_map(lambda t: t.to(device), shd.shard_tree(params, specs,
                                                             mesh))
    opt = adamw_init(local, opt_cfg, specs, mesh)
    step = steps_mod.make_train_step(cfg, opt_cfg, device=device,
                                     qat_enabled=qat,
                                     accum_steps=accum_steps,
                                     param_specs=specs, mesh=mesh)
    metrics = []
    for batch in batches:
        local, opt, m = step(local, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    mspecs = moment_specs(local, specs, mesh, opt_cfg.zero1)
    return {"metrics": metrics, "state": tuple(
        tree_map(lambda t: t.cpu(), shd.gather_tree(tree, sp, mesh))
        for tree, sp in ((local, specs), (opt.m, mspecs), (opt.v, mspecs)))}
