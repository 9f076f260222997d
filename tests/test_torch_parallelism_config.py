"""The port's ``ParallelismConfig`` against the JAX package's: every case of
``tests/test_parallelism_config.py`` (the same inputs give the same sizes,
``*_dim_names``, flags and errors), the environment protocol, and what
building a mesh of a dim that is not ported yet raises. Meshes at world
sizes 2 and 4 are built in ``tests/test_torch_collectives.py``.
"""

import dataclasses

import pytest

from accelerate_tpu.parallelism_config import ParallelismConfig as JConfig
from accelerate_tpu.utils.environment import patch_environment
from accelerate_tpu_torch.parallelism_config import ParallelismConfig

# name -> (constructor fields, total devices to validate against or None,
# environment for from_env or None)
CASES = {
    "defaults_single": (dict(), None, None),
    "dp_shard_inference": (dict(dp_shard_size=-1, tp_size=2), 8, None),
    "dp_replicate_inference": (dict(dp_replicate_size=-1, dp_shard_size=2), 8, None),
    "both_inferred": (dict(dp_replicate_size=-1, dp_shard_size=-1), 8, None),
    "invalid_total": (dict(dp_shard_size=3), 8, None),
    "not_divisible": (dict(dp_shard_size=-1, tp_size=3), 8, None),
    "zero_size": (dict(tp_size=0), 8, None),
    "cp_sp_exclusive": (dict(cp_size=2, sp_size=2, dp_shard_size=2), 8, None),
    "cp_sp_composable_when_allowed": (dict(cp_size=2, sp_size=2, dp_shard_size=2,
                                           allow_cp_with_sp=True), 8, None),
    "joint_axes": (dict(dp_replicate_size=2, dp_shard_size=2, cp_size=2), 8, None),
    "hsdp": (dict(dp_replicate_size=2, dp_shard_size=2), 4, None),
    "ddp_two": (dict(dp_replicate_size=2), 2, None),
    "hybrid_dcn": (dict(dp_replicate_size=2, dp_shard_size=4, hybrid_dcn_replicate=True), 8, None),
    "from_env": (None, 8, dict(PARALLELISM_CONFIG_DP_SHARD_SIZE=4, PARALLELISM_CONFIG_TP_SIZE=2)),
    "from_env_pp_virtual_stages": (None, 8, dict(
        PARALLELISM_CONFIG_PP_SIZE=2, PARALLELISM_CONFIG_DP_SHARD_SIZE=4,
        PARALLELISM_CONFIG_PP_MICROBATCHES=2, PARALLELISM_CONFIG_PP_VIRTUAL_STAGES=2)),
    "from_env_default_ddp": (None, 4, dict()),
    "from_env_inferred_shard": (None, 4, dict(PARALLELISM_CONFIG_DP_SHARD_SIZE=-1)),
}

PROPERTIES = ("axis_sizes", "dp_dim_names", "fsdp_dim_names", "loss_dim_names", "batch_dim_names",
              "seq_dim_names", "dcn_axis_names", "data_parallel_size", "non_data_parallel_size",
              "total_size", "dp_enabled", "fsdp_enabled", "hsdp_enabled", "tp_enabled",
              "cp_enabled", "sp_enabled", "pp_enabled", "ep_enabled", "active_mesh_dims")


def _observe(cls, fields, total, env):
    """Every property and the pp config's fields after construction and
    validation, or the error's type and message."""
    try:
        if fields is None:
            with patch_environment(**env):
                cfg = cls.from_env(total_devices=total)
        else:
            cfg = cls(**fields)
            if total is not None:
                cfg._infer_and_validate(total)
    except (ValueError, NotImplementedError) as e:
        return ("error", type(e).__name__, str(e).split(";")[0].split("(")[0].strip())
    out = {name: getattr(cfg, name) for name in PROPERTIES}
    out["pp_config"] = (None if cfg.pp_config is None else
                        {f.name: getattr(cfg.pp_config, f.name)
                         for f in dataclasses.fields(cfg.pp_config)})
    out["repr"] = repr(cfg)
    out["json"] = cfg.to_json()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_equals_the_jax_config(case):
    fields, total, env = CASES[case]
    assert _observe(ParallelismConfig, fields, total, env) == _observe(JConfig, fields, total, env)


def test_config_takes_every_field_of_the_jax_config():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert {f.name: f.default for f in dataclasses.fields(ParallelismConfig)} == jax_fields


@pytest.mark.parametrize("axis,item", [("tp", "A7"), ("cp", "A11"), ("sp", "A11"), ("pp", "A11"),
                                       ("ep", "A11")])
def test_a_mesh_of_a_queued_dim_names_its_item(axis, item):
    from accelerate_tpu_torch.state import AcceleratorState, PartialState

    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        PartialState(cpu=True)
        cfg = ParallelismConfig(**{f"{axis}_size": 2})
        cfg._total_devices = 2  # as if validated on two processes: refused before any group
        cfg._infer_and_validate(2)
        with pytest.raises(NotImplementedError, match=rf"ROADMAP.md {item}\b"):
            cfg.build_device_mesh()
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
