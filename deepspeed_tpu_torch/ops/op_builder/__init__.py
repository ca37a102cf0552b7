"""Host-op build system (JAX ``ops/op_builder``)."""

from .builder import (  # noqa: F401
    ALL_OPS,
    AsyncIOBuilder,
    CPUAdagradBuilder,
    CPUAdamBuilder,
    CPULionBuilder,
    OpBuilder,
    OpBuilderError,
    create_op_builder,
    get_op_builder,
)
