"""DataFrame front end of the port: ``Session`` → ``DataFrame`` →
protobuf ``TaskDefinition`` → planner → executor."""

from auron_tpu_torch.frontend.dataframe import (  # noqa: F401
    DataFrame, col, functions, lit, scalar_subquery)
from auron_tpu_torch.frontend.session import Session  # noqa: F401
