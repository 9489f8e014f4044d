"""The training side of the port (counterpart of :mod:`repro.train`): the
train-step builder (:mod:`repro_torch.train.step`) and the deterministic
training-plant model that the training-loop binding
(:mod:`repro_torch.runtime.plant`) drives."""
from repro_torch.train.plant_model import make_stream_plant_model
from repro_torch.train.step import TrainStepConfig, build_train_step

__all__ = ["TrainStepConfig", "build_train_step",
           "make_stream_plant_model"]
