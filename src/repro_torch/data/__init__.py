"""Synthetic data of the port: numpy copies of ``repro/data``, so one
seed gives the same arrays in both packages."""
from repro_torch.data.synthetic import evidence_batch, lm_batches  # noqa: F401
from repro_torch.data.tasks import ChainTask, SimulatedDecoder  # noqa: F401
