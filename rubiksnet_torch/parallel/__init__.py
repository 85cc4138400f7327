"""Data, tensor and sequence parallelism of the PyTorch port on
torch.distributed: the counterpart of ``rubiksnet_tpu/parallel``, one
process per rank."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Shard,
    active_data_group,
    active_model_group,
    all_reduce_sum,
    choose_backend,
    collective_counters,
    column_parallel,
    copy_to_model_group,
    create_mesh,
    data_parallel,
    gather_channels,
    gather_params,
    gather_rows,
    gather_shard,
    group_rank,
    group_size,
    initialize_distributed,
    model_parallel,
    param_partition_spec,
    rank0_log,
    replicated,
    shard_batch,
    shard_params,
    shard_state,
    sharded_modules,
)
from .temporal import (
    TIME_AXIS,
    active_time_group,
    halo_exchange_time,
    halo_width,
    sequence_parallel_eval,
    temporal_attention_shift,
    temporal_rubiks_shift_3d,
    time_parallel,
    time_shard_clip,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "Shard", "TIME_AXIS",
    "active_data_group", "active_model_group", "active_time_group",
    "all_reduce_sum", "choose_backend", "collective_counters",
    "column_parallel", "copy_to_model_group", "create_mesh",
    "data_parallel", "gather_channels", "gather_params", "gather_rows",
    "gather_shard", "group_rank", "group_size", "halo_exchange_time",
    "halo_width", "initialize_distributed", "model_parallel",
    "param_partition_spec", "rank0_log", "replicated",
    "sequence_parallel_eval", "shard_batch", "shard_params", "shard_state",
    "sharded_modules", "temporal_attention_shift",
    "temporal_rubiks_shift_3d", "time_parallel", "time_shard_clip",
]
