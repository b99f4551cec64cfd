"""Plan IR of the port: the protobuf host ↔ engine contract, its
conversion to and from the port's IR, and the physical planner.

``auron.proto`` is a copy of the reference's under the package name
``auron_tpu_torch.ir``; ``auron_pb2.py`` is generated from it with
``protoc --python_out=. auron_tpu_torch/ir/auron.proto`` (protoc 3.21,
run from the root of the repo; it needs protobuf 3.20 or later at run
time) and checked in.
"""

from auron_tpu_torch.ir import auron_pb2 as pb  # noqa: F401
from auron_tpu_torch.ir.planner import (PhysicalPlanner,  # noqa: F401
                                        PlannerContext, plan_from_bytes)
from auron_tpu_torch.ir.serde import (agg_to_proto,  # noqa: F401
                                      expr_to_proto, parse_agg, parse_expr,
                                      parse_schema, parse_sort_order,
                                      schema_to_proto, sort_order_to_proto)
