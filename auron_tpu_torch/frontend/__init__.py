"""DataFrame front end of the port: ``Session`` → ``DataFrame`` →
protobuf ``TaskDefinition`` → planner → executor."""

from auron_tpu_torch.frontend.dataframe import (DataFrame, col,  # noqa: F401
                                                functions, lit)
from auron_tpu_torch.frontend.session import Session  # noqa: F401
