"""The training side of the port (counterpart of :mod:`repro.train`): so
far the deterministic training-plant model that the training-loop binding
(:mod:`repro_torch.runtime.plant`) drives."""
from repro_torch.train.plant_model import make_stream_plant_model

__all__ = ["make_stream_plant_model"]
