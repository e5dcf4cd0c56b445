from raindrop_tpu_torch.data.collate import (  # noqa: F401
    RaggedRecord,
    data_min_max,
    records_from_dense,
    variable_time_collate,
)
from raindrop_tpu_torch.data.raw_irregular import (  # noqa: F401
    load_person_activity,
    load_physionet_dir,
    parse_person_activity,
    parse_physionet_outcomes,
    parse_physionet_record,
    union_time_collate,
)
