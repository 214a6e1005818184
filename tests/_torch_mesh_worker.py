"""Ranks of the port's multi-process tests (``test_torch_mesh.py``, ``test_torch_distributed.py``).

:func:`spawn` starts one process per rank with the ``spawn`` start method; the ranks meet
through a ``file://`` rendezvous in a directory of the test's own, form a gloo process
group on the CPU, run the scenarios they are given and each write their results to that
directory. Nothing here imports JAX: the parent test holds the results against the JAX
package. Every operand comes from the parent as a NumPy array, so both sides see the
same bits.
"""

import os
import pickle
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.overrides import TorchFunctionMode

# One worker process per rank, several test files at once under xdist: keep each rank to
# one thread so that the ranks do not starve each other.
THREADS_PER_RANK = 1


def spawn(fn: Any, nprocs: int, workdir: Path, *args: Any, timeout: float = 600.0) -> list[Any]:
    """Run ``fn(rank, nprocs, workdir, *args)`` in ``nprocs`` fresh processes and return
    what each rank wrote with :func:`_write`, in rank order. A rank that raises fails the
    call with its traceback; a run past ``timeout`` seconds is killed and fails it."""
    workdir.mkdir(parents=True, exist_ok=True)
    context = mp.start_processes(fn, args=(nprocs, workdir, *args), nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                msg = f"the {nprocs} ranks did not finish within {timeout} s"
                raise TimeoutError(msg)
    finally:
        for proc in context.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
    return [pickle.loads((workdir / f"rank{rank}.pkl").read_bytes()) for rank in range(nprocs)]


def _write(workdir: Path, rank: int, payload: Any) -> None:
    (workdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(payload))


def _join_group(rank: int, world: int, workdir: Path) -> None:
    import datetime  # noqa: PLC0415

    import torch.distributed as dist  # noqa: PLC0415

    torch.set_num_threads(THREADS_PER_RANK)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{workdir}/rendezvous",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=300),
    )


def _leave_group() -> None:
    """Destroy the rank's process groups before it exits. Left to interpreter exit, gloo's
    teardown takes seconds a rank and, under load, can abort one (SIGABRT, "terminate called
    without an active exception") after every rank has written its results."""
    import torch.distributed as dist  # noqa: PLC0415

    dist.destroy_process_group()


def _arrays(result: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in result.items()}


class _TF32Products(TorchFunctionMode):
    """Records the operand shapes of every matrix product that runs while the CUDA fp32
    precision is "tf32" (the port's scope of precision="fast")."""

    PRODUCTS = (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.matmul, torch.mm)

    def __init__(self) -> None:
        super().__init__()
        self.seen: list[tuple] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS and torch.backends.cuda.matmul.fp32_precision == "tf32":
            self.seen.append((tuple(args[0].shape), tuple(args[1].shape)))
        return func(*args, **(kwargs or {}))


def _recording(run: Any) -> dict[str, Any]:
    """``run()`` with its TF32 products recorded, and the ``precision`` each K2 call of
    the streaming solver was given."""
    from neo_ls_svm_torch.models import primal  # noqa: PLC0415

    precisions, real = [], primal.fused_loo_sweep

    def sweep(*args: Any, **kwargs: Any) -> Any:
        precisions.append(kwargs["precision"])
        return real(*args, **kwargs)

    primal.fused_loo_sweep = sweep
    try:
        with _TF32Products() as products:
            out = run()
    finally:
        primal.fused_loo_sweep = real
    return {"out": out, "tf32_products": products.seen, "sweep_precisions": precisions}


def _sharded(mesh: Any, case: dict[str, Any]) -> dict[str, np.ndarray]:
    from neo_ls_svm_torch.parallel.mesh import (  # noqa: PLC0415
        sharded_primal_fit,
        sharded_primal_fit_streaming,
    )

    operands = [case[k] for k in ("X", "M", "b", "y", "s", "gammas")]
    kwargs = {"is_classifier": case.get("is_classifier", False), "sweep_precision": case.get("sweep_precision", "high")}
    if case["route"] == "streaming":
        return _arrays(
            sharded_primal_fit_streaming(mesh, *operands, case.get("C"), row_chunk=case["row_chunk"], **kwargs)
        )
    return _arrays(sharded_primal_fit(mesh, *operands, case.get("C"), **kwargs))


def _spied_streaming(mesh: Any, case: dict[str, Any]) -> dict[str, Any]:
    """The streaming fit with the collectives spied on: the shapes of every sum over the
    ``feature`` group and of every column gather."""
    from neo_ls_svm_torch.parallel import collectives  # noqa: PLC0415

    feature = mesh.get_group("feature")
    sums, gathers = [], []
    real_sum, real_gather = collectives.sum_over, collectives.gather_columns

    def spy_sum(t: torch.Tensor, group: Any) -> torch.Tensor:
        if group is feature:
            sums.append(tuple(t.shape))
        return real_sum(t, group)

    def spy_gather(t: torch.Tensor, group: Any) -> torch.Tensor:
        gathers.append(tuple(t.shape))
        return real_gather(t, group)

    collectives.sum_over, collectives.gather_columns = spy_sum, spy_gather
    try:
        result = _sharded(mesh, case)
    finally:
        collectives.sum_over, collectives.gather_columns = real_sum, real_gather
    return {"result": result, "feature_sums": sums, "column_gathers": gathers}


def _precision_spied(mesh: Any, case: dict[str, Any]) -> dict[str, Any]:
    """A sharded fit with its TF32 products and K2 precisions recorded."""
    recorded = _recording(lambda: _sharded(mesh, case))
    return {"result": recorded.pop("out"), **recorded}


def _estimator(mesh: Any, case: dict[str, Any]) -> dict[str, Any]:
    """A ``NeoLSSVM`` fit on the CPU with this mesh (or none), its fitted state and its
    predictions on the first 100 rows; on rank 0 also its conformal answers, its pickle
    and state dict, and what they predict once restored."""
    import torch.distributed as dist  # noqa: PLC0415

    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415
    from neo_ls_svm_torch.models import estimator as est  # noqa: PLC0415

    X, y = case["X"], case["y"]
    params = {"device": "cpu", **case.get("params", {})}
    if case.get("mesh", True):
        params["mesh"] = mesh
    saved = est.STREAMING_BYTES_THRESHOLD
    est.STREAMING_BYTES_THRESHOLD = case.get("streaming_bytes_threshold", saved)
    recorded: dict[str, Any] = {}
    try:
        if case.get("record"):
            recorded = _recording(lambda: NeoLSSVM(**params).fit(X, y))
            model = recorded.pop("out")
        else:
            model = NeoLSSVM(**params).fit(X, y)
    except ValueError as error:
        if case.get("expect_error"):
            return {"error": str(error)}
        raise
    finally:
        est.STREAMING_BYTES_THRESHOLD = saved
    head = X[:100]
    out = {
        "mesh_shape": None if model.mesh_ is None else tuple(model.mesh_.shape),
        "same_mesh": model.mesh_ is mesh,
        "gamma": model.γ_,
        "loo_score": model.loo_score_,
        "loo_residuals": model.loo_residuals_,
        "loo_std": model.loo_std_,
        "pre_transform": model.pre_transform_,
        "M_map": model._M_map,
        "b_map": model._b_map,
        "predict": model.predict(head),
        "predict_std": model.predict_std(head),
        **recorded,
    }
    if dist.get_rank() != 0:  # serving is local: rank 0 stands for every rank
        return out
    if case.get("conformal"):
        out["quantiles"] = model.predict_quantiles(head, quantiles=(0.025, 0.5, 0.975))
        out["interval"] = model.predict_interval(head, coverage=0.9)
    if case.get("persist"):
        out["pickle"] = pickle.dumps(model)
        out["state_dict"] = model.to_state_dict()
        restored = {
            "pickle": pickle.loads(out["pickle"]),
            "state_dict": NeoLSSVM.from_state_dict(out["state_dict"], device="cpu"),
        }
        out["restored"] = {how: (m.predict(head), m.predict_std(head)) for how, m in restored.items()}
    return out


def _pretransform(mesh: Any, case: dict[str, Any]) -> dict[str, Any]:
    """``sharded_device_pre_transform`` on this rank's block of the case's rows (the
    injected ``draws``, or a generator seeded with ``seed``), with the X that reaches
    ``device_pre_transform`` recorded; and the per-bin medians of the rank's block through
    ``grouped_weighted_median`` with the mesh's hooks."""
    from functools import partial  # noqa: PLC0415

    from neo_ls_svm_torch.ops.affine import grouped_weighted_median  # noqa: PLC0415
    from neo_ls_svm_torch.ops.pretransform_device import _target_codes  # noqa: PLC0415
    from neo_ls_svm_torch.parallel import collectives  # noqa: PLC0415
    from neo_ls_svm_torch.parallel import mesh as tmesh  # noqa: PLC0415

    cpu = torch.device("cpu")
    num_data = tmesh.axis_size(mesh, "data")
    X_l = tmesh._stage_rows(mesh, case["X"], num_data, cpu)
    y, w = (tmesh._stage_padded(case[k], num_data, cpu) for k in ("y", "w"))
    seen, real = [], tmesh.device_pre_transform

    def spy(X: torch.Tensor, *args: Any, **kwargs: Any) -> Any:
        seen.append(X.numpy().copy())
        return real(X, *args, **kwargs)

    generator = None
    if case.get("seed") is not None:
        generator = torch.Generator()
        generator.manual_seed(case["seed"])
    tmesh.device_pre_transform = spy
    try:
        pt = tmesh.sharded_device_pre_transform(mesh, X_l, y, w, generator, draws=case.get("draws"), **case["kw"])
    finally:
        tmesh.device_pre_transform = real
    data = mesh.get_group("data")
    num_bins, rows = case["kw"]["num_bins"], tmesh._block(mesh, len(case["y"]), num_data)
    codes, _ = _target_codes(y, w, num_bins=num_bins, is_classifier=case["kw"]["is_classifier"])
    medians = grouped_weighted_median(
        X_l,
        w[rows],
        codes[rows],
        num_bins,
        row_sum=partial(collectives.sum_over, group=data),
        row_gather=partial(collectives.gather_rows, group=data),
    )
    return {"pt": _arrays(pt), "X_seen": seen, "rows": (rows.start, rows.stop), "medians": medians.numpy()}


def mesh_scenarios(rank: int, world: int, workdir: Path, shape: tuple[int, int], cases: dict) -> None:
    """Every case on one ("data", "feature") mesh of ``shape`` over the gloo world."""
    from neo_ls_svm_torch.parallel.mesh import make_mesh  # noqa: PLC0415

    _join_group(rank, world, workdir)
    mesh = make_mesh(*shape, device_type="cpu")
    runners = {
        "sharded": _sharded,
        "spied": _spied_streaming,
        "precision_spied": _precision_spied,
        "estimator": _estimator,
        "pretransform": _pretransform,
    }
    results = {name: runners[case["kind"]](mesh, case) for name, case in cases.items()}
    results["mesh_reused"] = make_mesh(*shape, device_type="cpu") is mesh
    _write(workdir, rank, results)
    _leave_group()


def distributed_scenario(rank: int, world: int, workdir: Path, case: dict) -> None:
    """``initialize_distributed`` and ``make_multihost_mesh`` in a world of ``world`` ranks,
    then both sharded fits on the multi-host mesh (the counterpart of
    ``tests/_multiprocess_worker.py``)."""
    import torch.distributed as dist  # noqa: PLC0415

    from neo_ls_svm_torch.parallel.distributed import (  # noqa: PLC0415
        initialize_distributed,
        make_multihost_mesh,
    )

    torch.set_num_threads(THREADS_PER_RANK)
    init = f"file://{workdir}/rendezvous"
    out: dict[str, Any] = {"first_call": initialize_distributed(init, world, rank, backend="gloo")}
    out["second_call"] = initialize_distributed(init, world, rank, backend="gloo")
    out["world_size"] = dist.get_world_size()
    out["backend"] = dist.get_backend()
    errors = {}
    for name, local_world, num_feature in (("uneven", world + 1, 1), ("indivisible", world, world + 1)):
        os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
        try:
            make_multihost_mesh(num_feature=num_feature, device_type="cpu")
        except ValueError as error:
            errors[name] = str(error)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    out["errors"] = errors
    mesh = make_multihost_mesh(device_type="cpu")
    out["mesh_shape"] = tuple(mesh.shape)
    for route, row_chunk in (("inmemory", None), ("streaming", 128)):
        out[route] = _sharded(mesh, {**case, "route": route, "row_chunk": row_chunk})
    _write(workdir, rank, out)
    _leave_group()
