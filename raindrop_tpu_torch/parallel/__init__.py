from raindrop_tpu_torch.parallel.elastic import (  # noqa: F401
    FaultInjector,
    Heartbeat,
    HeartbeatMonitor,
    SimulatedFailure,
    run_elastic,
)
from raindrop_tpu_torch.parallel.expert import (  # noqa: F401
    expert_parallel_specs,
    moe_ffn_apply,
    moe_ffn_init,
    shard_moe_params,
)
from raindrop_tpu_torch.parallel.mesh import (  # noqa: F401
    Shard,
    batch_rows,
    initialize_distributed,
    make_mesh,
    shard_params,
    tensor_parallel_specs,
)
from raindrop_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_transformer_encoder,
    stack_stage_params,
)
