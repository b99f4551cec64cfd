"""Device-resident vectorized hash table: the port of
``auron_tpu.hashtable``, in PyTorch ops.

Three public operations:

- ``build``: insert key columns, get stable slot ids
  (``DeviceHashTable.insert`` / ``core.insert_loop``);
- ``probe``: lookup-only (``DeviceHashTable.probe``, and the hash-join
  candidate index ``build_join_index``/``JoinHashIndex``);
- ``agg_update``: slot-indexed accumulator scatters
  (``core.agg_update``; per batch in ``HashAggState.update``, once in
  ``grouped_agg_once``).
"""

from auron_tpu_torch.hashtable.agg import (HashAggState, HashTableOverflow,
                                           grouped_agg_once)
from auron_tpu_torch.hashtable.core import SUPPORTED_KINDS
from auron_tpu_torch.hashtable.table import (DeviceHashTable, JoinHashIndex,
                                             build_join_index)

__all__ = [
    "DeviceHashTable", "HashAggState", "HashTableOverflow",
    "JoinHashIndex", "SUPPORTED_KINDS", "build_join_index",
    "grouped_agg_once",
]
