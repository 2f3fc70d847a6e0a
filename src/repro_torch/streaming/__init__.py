"""Streaming engine, state store and durability layer of the PyTorch port."""
from repro_torch.streaming import faults
from repro_torch.streaming.async_checkpoint import AsyncCheckpointer
from repro_torch.streaming.engine import (AdmissionResult, Backpressure,
                                          Event, ForgetReceipt,
                                          InvalidEventError,
                                          ShardedStreamingEngine,
                                          StreamingEngine)
from repro_torch.streaming.state_store import (CorruptCheckpointError,
                                               StateStore, StoreConfig,
                                               load_checkpoint_arrays,
                                               load_json_checked,
                                               with_io_retries)

__all__ = ["faults", "AsyncCheckpointer", "AdmissionResult", "Backpressure",
           "Event", "ForgetReceipt", "InvalidEventError",
           "ShardedStreamingEngine", "StreamingEngine",
           "CorruptCheckpointError", "StateStore", "StoreConfig",
           "load_checkpoint_arrays", "load_json_checked", "with_io_retries"]
