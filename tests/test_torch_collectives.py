"""The port's process collectives, mesh collectives, loader rows and
launchers across gloo processes on the CPU.

One launch of two ranks (``debug_launcher``, a ``file://`` store in the
test's temporary directory) runs every check and returns its result; each
check is its own case:

* ``ops/operations.py`` and ``PartialState``: the body of the JAX package's
  ``tests/test_multiprocess.py::_worker_body`` with its expected values
  (barrier, gather, gather_object, broadcast, broadcast_object_list,
  reduce, pad_across_processes, split_between_processes);
* ``ops/collectives.py`` over a ``DeviceMesh`` dim: the values of ``lax``'s
  collectives on two shards, and gradients through the differentiable
  ones;
* loader rows: each rank's rows against the JAX package's
  ``data_shard_info`` and ``DataLoaderShard`` at that process index and
  two processes, with and without ``dispatch_batches``;
* meshes: ``ParallelismConfig.build_device_mesh`` and HSDP's 2-D mesh;
* the kernel wrappers refuse a ``DTensor`` (an FSDP2 shard), here too.

Then ``notebook_launcher(num_processes=2, cpu=True)``, the launch
command's ``--dry_run`` and its refusals, and the sanity script
``test_utils/scripts/test_script.py`` (``training_check`` and
``llama_check`` at atol 1e-6, a checkpoint round trip) through ``python -m
accelerate_tpu_torch.commands.launch --cpu --num_processes 2``, under DDP
and under FSDP2.
"""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

DATA_ROWS = 16


def _checks():
    """Every check on this rank: {name: (passed, detail)}."""
    import torch.distributed as dist

    from accelerate_tpu_torch.data_loader import batch_sharding, data_shard_info, prepare_data_loader
    from accelerate_tpu_torch.ops import collectives as C
    from accelerate_tpu_torch.ops import operations as ops
    from accelerate_tpu_torch.parallel.mesh import build_hybrid_mesh
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import PartialState

    state = PartialState()
    rank = state.process_index
    out = {}

    def check(name, fn):
        try:
            ok, detail = fn()
        except Exception as e:  # noqa: BLE001 - reported as the case's failure
            ok, detail = False, f"{type(e).__name__}: {e}"
        out[name] = (bool(ok), detail)

    # -- the JAX package's two-process body, its expected values
    check("num_processes", lambda: (state.num_processes == 2, state.num_processes))
    check("barrier", lambda: (state.wait_for_everyone(timeout=60) is None, None))
    gathered = ops.gather(torch.full((2, 1), float(rank)))
    check("gather", lambda: (tuple(gathered.shape) == (4, 1) and sorted(gathered.ravel().tolist())
                             == [0.0, 0.0, 1.0, 1.0], gathered.tolist()))
    objs = ops.gather_object([f"rank{rank}"])
    check("gather_object", lambda: (objs == ["rank0", "rank1"], objs))
    bcast = ops.broadcast(torch.full((3,), float(rank + 1)), from_process=0)
    check("broadcast", lambda: (bcast.tolist() == [1.0, 1.0, 1.0], bcast.tolist()))
    payload = ops.broadcast_object_list([{"rank": rank}], from_process=0)
    check("broadcast_object_list", lambda: (payload[0]["rank"] == 0, payload))
    red = ops.reduce(torch.full((2,), float(rank)), reduction="mean")
    check("reduce_mean", lambda: (red.tolist() == [0.5, 0.5], red.tolist()))
    red_sum = ops.reduce(torch.full((2,), float(rank + 1)), reduction="sum", scale=2.0)
    check("reduce_sum_scaled", lambda: (red_sum.tolist() == [6.0, 6.0], red_sum.tolist()))
    padded = ops.pad_across_processes(torch.ones((1 + 2 * rank, 2)), dim=0)
    check("pad_across_processes", lambda: (tuple(padded.shape) == (3, 2), tuple(padded.shape)))
    with state.split_between_processes(list(range(10))) as chunk:
        check("split_between_processes", lambda: (len(chunk) == 5 and chunk[0] == 5 * rank, chunk))
    with state.split_between_processes(list(range(9)), apply_padding=True) as chunk:
        check("split_between_processes_padding",
              lambda: (chunk == ([0, 1, 2, 3, 4] if rank == 0 else [5, 6, 7, 8, 8]), chunk))

    # -- mesh collectives over a ("dp_shard",) dim of 2
    mesh = ParallelismConfig(dp_shard_size=2).build_device_mesh()
    check("build_device_mesh", lambda: (mesh.mesh_dim_names == ("dp_shard",)
                                        and mesh.size() == 2, str(mesh)))
    x = torch.arange(4.0) + 10 * rank  # rank 0: 0..3, rank 1: 10..13
    check("psum", lambda: (C.psum(x, "dp_shard", mesh).tolist() == [10.0, 12.0, 14.0, 16.0], None))
    check("pmean", lambda: (C.pmean(x, "dp_shard", mesh).tolist() == [5.0, 6.0, 7.0, 8.0], None))
    check("pmax", lambda: (C.pmax(x, "dp_shard", mesh).tolist() == [10.0, 11.0, 12.0, 13.0], None))
    check("pmin", lambda: (C.pmin(x, "dp_shard", mesh).tolist() == [0.0, 1.0, 2.0, 3.0], None))
    check("all_gather_tiled", lambda: (C.all_gather(x, "dp_shard", mesh=mesh).tolist()
                                       == [0.0, 1.0, 2.0, 3.0, 10.0, 11.0, 12.0, 13.0], None))
    check("all_gather_stacked", lambda: (tuple(C.all_gather(x, "dp_shard", tiled=False, mesh=mesh)
                                               .shape) == (2, 4), None))
    rs = C.reduce_scatter(x, "dp_shard", mesh=mesh)
    check("reduce_scatter", lambda: (rs.tolist() == ([10.0, 12.0] if rank == 0 else [14.0, 16.0]),
                                     rs.tolist()))
    shifted = C.ring_shift(x, "dp_shard", mesh=mesh)
    check("ring_shift", lambda: (shifted.tolist() == (x + (10 if rank == 0 else -10)).tolist(),
                                 shifted.tolist()))
    perm = C.ppermute(x, "dp_shard", [(0, 1)], mesh=mesh)
    check("ppermute_unsent_is_zero", lambda: (perm.tolist() == ([0.0] * 4 if rank == 0 else
                                                               [0.0, 1.0, 2.0, 3.0]), perm.tolist()))
    a2a = C.all_to_all(x, "dp_shard", split_dim=0, concat_dim=0, mesh=mesh)
    check("all_to_all", lambda: (a2a.tolist() == ([0.0, 1.0, 10.0, 11.0] if rank == 0
                                                  else [2.0, 3.0, 12.0, 13.0]), a2a.tolist()))
    check("broadcast_from", lambda: (C.broadcast_from(x, "dp_shard", src=1, mesh=mesh).tolist()
                                     == [10.0, 11.0, 12.0, 13.0], None))
    check("axis_index_size", lambda: (C.axis_index("dp_shard", mesh) == rank
                                      and C.axis_size("dp_shard", mesh) == 2, None))
    w = torch.full((2,), float(rank + 1), requires_grad=True)
    (C.psum(w * w, "dp_shard", mesh).sum()).backward()
    # d/dw_r of sum over ranks of (sum_s w_s^2): every rank's loss counts
    check("psum_gradient", lambda: (w.grad.tolist() == [4.0 * (rank + 1)] * 2, w.grad.tolist()))
    v = torch.full((2,), float(rank + 1), requires_grad=True)
    g = C.all_gather(v, "dp_shard", mesh=mesh)
    (g * torch.arange(4.0)).sum().backward()
    # the transpose of a gather is a reduce-scatter (lax's psum_scatter):
    # both ranks' losses weigh this rank's slice of the gather
    check("all_gather_gradient", lambda: (v.grad.tolist() == ([0.0, 2.0] if rank == 0
                                                              else [4.0, 6.0]), v.grad.tolist()))

    # -- a kernel wrapper given a DTensor raises, on the CPU too: it never
    # falls back to the plain version on a shard
    from torch.distributed.tensor import Replicate, distribute_tensor

    from accelerate_tpu_torch.ops.flash_attention import flash_attention
    from accelerate_tpu_torch.ops.paged_decode import fused_sample
    from accelerate_tpu_torch.ops.quant_matmul import quantized_matmul

    def refused(call):
        try:
            call()
        except TypeError as e:
            return "DTensor" in str(e), str(e)
        return False, "no error"

    dq = distribute_tensor(torch.zeros(1, 8, 2, 16), mesh, [Replicate()])
    check("flash_refuses_dtensor", lambda: refused(lambda: flash_attention(dq, dq, dq)))
    dl = distribute_tensor(torch.zeros(2, 16), mesh, [Replicate()])
    check("fused_sample_refuses_dtensor", lambda: refused(lambda: fused_sample(
        dl, dl, torch.ones(2), torch.zeros(2, dtype=torch.int32), torch.ones(2))))
    dx = distribute_tensor(torch.zeros(4, 8), mesh, [Replicate()])
    check("quantized_matmul_refuses_dtensor", lambda: refused(lambda: quantized_matmul(
        dx, torch.zeros(8, 8, dtype=torch.int8), torch.ones(8))))

    # -- seeds: each rank seeded apart, then rank 0's states everywhere
    from accelerate_tpu_torch.utils.random import set_seed, synchronize_rng_states

    set_seed(5, device_specific=True)
    apart = ops.gather(torch.rand(1))
    synchronize_rng_states(["python", "numpy", "torch"])
    together = ops.gather(torch.cat([torch.rand(1), torch.tensor([float(np.random.rand())])]))
    check("synchronize_rng_states", lambda: (apart[0] != apart[1]
                                             and together[:2].tolist() == together[2:].tolist(),
                                             (apart.tolist(), together.tolist())))

    # -- the loader's rows on that mesh
    data = {"x": np.arange(float(DATA_ROWS))[:, None]}
    info = data_shard_info(batch_sharding(mesh))
    rows = [b["x"][:, 0].tolist() for b in prepare_data_loader(
        data, device="cpu", batch_size=4, drop_last=True, mesh=mesh)]
    dispatched = [b["x"][:, 0].tolist() for b in prepare_data_loader(
        data, device="cpu", batch_size=4, drop_last=True, mesh=mesh, dispatch_batches=True)]
    shuffled = [b["x"][:, 0].tolist() for b in prepare_data_loader(
        data, device="cpu", batch_size=4, shuffle=True, seed=3, mesh=mesh, rng_types=["torch"])]
    hybrid = build_hybrid_mesh((1, 1), (1, 2), ("dp_replicate", "dp_shard"))
    check("hybrid_mesh", lambda: (hybrid.mesh_dim_names == ("dp_replicate", "dp_shard"), str(hybrid)))
    dist.barrier()
    return out, {"info": info, "rows": rows, "dispatched": dispatched, "shuffled": shuffled}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    return debug_launcher(_checks, num_processes=2, init_method=f"file://{tmp}/store")


CHECKS = ("num_processes", "barrier", "gather", "gather_object", "broadcast", "broadcast_object_list",
          "reduce_mean", "reduce_sum_scaled", "pad_across_processes", "split_between_processes",
          "split_between_processes_padding", "build_device_mesh", "hybrid_mesh", "psum", "pmean",
          "pmax", "pmin", "all_gather_tiled", "all_gather_stacked", "reduce_scatter", "ring_shift",
          "ppermute_unsent_is_zero", "all_to_all", "broadcast_from", "axis_index_size",
          "psum_gradient", "all_gather_gradient", "synchronize_rng_states",
          "flash_refuses_dtensor", "fused_sample_refuses_dtensor",
          "quantized_matmul_refuses_dtensor")


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", CHECKS)
def test_collective(ranks, name, rank):
    ok, detail = ranks[rank][0][name]
    assert ok, detail


def _jax_rows(process_index):
    """The JAX package's rows for ``process_index`` of two processes: its
    shard info on a 2-device ``dp_shard`` mesh (one device a process), its
    ``DataLoaderShard`` batches, and the block of each dispatched global
    batch that process's devices hold."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from accelerate_tpu import data_loader as jdl

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp_shard",))
    info = jdl.data_shard_info(NamedSharding(mesh, P("dp_shard")), process_index=process_index,
                               num_processes=2, process_of_device=lambda d: d.id)
    num_shards, shard_index, _ = info
    data = {"x": np.arange(float(DATA_ROWS))[:, None]}
    base = jdl._SimpleBatchSampler(range(DATA_ROWS), 4, drop_last=True)
    shard = jdl.BatchSamplerShard(base, num_processes=num_shards, process_index=shard_index,
                                  even_batches=True)
    rows = [b["x"][:, 0].tolist() for b in jdl._ArrayBatcher(data, shard)]
    glob = jdl._ArrayBatcher(data, jdl._SimpleBatchSampler(range(DATA_ROWS), 8, drop_last=True))
    per = 8 // num_shards
    dispatched = [b["x"][shard_index * per:(shard_index + 1) * per, 0].tolist() for b in glob]
    return info, rows, dispatched


@pytest.mark.parametrize("what", ["info", "rows", "dispatched"])
@pytest.mark.parametrize("rank", [0, 1])
def test_loader_rows_equal_the_jax_package(ranks, rank, what):
    info, rows, dispatched = _jax_rows(rank)
    assert ranks[rank][1][what] == {"info": info, "rows": rows, "dispatched": dispatched}[what]


def test_shuffled_rows_cover_the_data_once(ranks):
    # rng_types synchronized from rank 0: both ranks draw one permutation
    seen = sorted(v for r in ranks for batch in r[1]["shuffled"] for v in batch)
    assert seen == list(np.arange(float(DATA_ROWS)))


# -------------------------------------------------------------- launchers
def _notebook_body(path):
    """A notebook-style function: its own Accelerator, a gather, a file."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import PartialState

    acc = Accelerator()
    ranks = acc.gather(torch.tensor([float(acc.process_index)])).tolist()
    if acc.is_main_process:
        with open(path, "w") as f:
            f.write(f"{PartialState().num_processes} {ranks} {acc.device}")


def test_notebook_launcher_runs_real_processes(tmp_path):
    from accelerate_tpu_torch.launchers import notebook_launcher

    path = tmp_path / "out.txt"
    notebook_launcher(_notebook_body, args=(str(path),), num_processes=2, cpu=True)
    assert path.read_text() == "2 [0.0, 1.0] cpu"


def test_notebook_launcher_in_process_and_failures():
    from accelerate_tpu_torch.launchers import notebook_launcher

    ran = {}
    notebook_launcher(lambda x: ran.setdefault("x", x), args=(5,), num_processes=1)
    assert ran == {"x": 5}
    if not torch.cuda.is_available():
        # processes on the card need as many cards: no silent move to the CPU
        with pytest.raises(RuntimeError, match="cpu=True"):
            notebook_launcher(_notebook_body, args=("unused",), num_processes=2)


def _fails():
    raise ValueError("planted")


def test_launcher_raises_a_worker_traceback():
    with pytest.raises(RuntimeError, match="ValueError: planted"):
        debug_launcher(_fails, num_processes=2)


def test_launch_dry_run(capsys):
    from accelerate_tpu_torch.commands import launch

    assert launch.main(["--cpu", "--num_processes", "2", "--dp_shard_size", "2",
                        "--mixed_precision", "bf16", "--dry_run", "train.py", "--lr", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith("-m torch.distributed.run --nproc_per_node 2 --standalone train.py "
                             "--lr 1")
    assert lines[1:] == ["  ACCELERATE_MIXED_PRECISION=bf16", "  ACCELERATE_USE_CPU=1",
                         "  PARALLELISM_CONFIG_DP_SHARD_SIZE=2"]


@pytest.mark.parametrize("flag,item", [(["--max_restarts", "2"], "A7"), (["--handle_preemption"], "A7"),
                                       (["--replicate_to", "/x"], "A7")])
def test_launch_refuses_the_supervisor(flag, item, capsys):
    # A7's durability half landed: the supervisor's flags are taken, and
    # --dry_run prints what each arms
    from accelerate_tpu_torch.commands import launch

    assert launch.main([*flag, "--dry_run", "train.py"]) == 0
    out = capsys.readouterr().out
    assert f"ROADMAP.md {item}" not in out
    want = {"--max_restarts": "  supervisor: max_restarts=2 watchdog_timeout=0.0",
            "--handle_preemption": "  ACCELERATE_HANDLE_PREEMPTION=1",
            "--replicate_to": "  ACCELERATE_REPLICATION_TARGET=/x"}[flag[0]]
    assert want in out.splitlines() or any(line.startswith(want) for line in out.splitlines())


@pytest.mark.parametrize("layout", ["ddp", "fsdp"])
def test_launch_runs_the_sanity_script(layout):
    # under FSDP2 the regression's scalar parameters stay whole, their
    # gradients averaged by the optimizer
    from accelerate_tpu_torch.test_utils import testing

    script = os.path.join(os.path.dirname(testing.__file__), "scripts", "test_script.py")
    args = ["--dp_shard_size", "2"] if layout == "fsdp" else []
    out = testing.launch_script(script, launch_args=["--cpu", "--num_processes", "2", *args],
                                timeout=300)
    for line in ("training parity ok", f"llama parity ok ({layout}", "checkpoint ok",
                 "All checks passed", f"num_processes=2, layout='{layout}'"):
        assert line in out.stdout, out.stdout
