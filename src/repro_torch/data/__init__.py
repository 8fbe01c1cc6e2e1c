"""The training port's data pipeline and shard balancing
(``repro/data``)."""

from repro_torch.data.balance import assign_shards, host_load_cv  # noqa: F401
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: F401
