"""Checkpoints and output writers (counterpart of `climaseaice_jl_tpu/io`)."""

from .checkpoint import save_checkpoint, load_checkpoint, restore_state, Checkpointer
from .writers import (NPZWriter, NetCDFWriter, FieldTimeSeriesAccumulator,
                      default_output_attributes)

__all__ = ["save_checkpoint", "load_checkpoint", "restore_state", "Checkpointer",
           "NPZWriter", "NetCDFWriter", "FieldTimeSeriesAccumulator",
           "default_output_attributes"]
