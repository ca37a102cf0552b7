"""Async file I/O for the NVMe tier (JAX ``ops/aio``)."""

from .async_io import AsyncIOError, AsyncIOHandle  # noqa: F401
