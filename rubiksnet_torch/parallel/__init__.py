"""Data and sequence parallelism of the PyTorch port on torch.distributed:
the counterpart of ``rubiksnet_tpu/parallel``, one process per rank."""

from .mesh import (
    DATA_AXIS,
    active_data_group,
    all_reduce_sum,
    choose_backend,
    create_mesh,
    data_parallel,
    gather_rows,
    group_rank,
    group_size,
    initialize_distributed,
    rank0_log,
    replicated,
    shard_batch,
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
    "DATA_AXIS", "TIME_AXIS", "active_data_group",
    "active_time_group", "all_reduce_sum", "choose_backend", "create_mesh",
    "data_parallel", "gather_rows", "group_rank", "group_size",
    "halo_exchange_time", "halo_width", "initialize_distributed",
    "rank0_log", "replicated", "sequence_parallel_eval", "shard_batch",
    "temporal_attention_shift", "temporal_rubiks_shift_3d",
    "time_parallel", "time_shard_clip",
]
