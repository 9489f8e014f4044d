"""The training side of the port (counterpart of :mod:`repro.train`): the
train-step builder (:mod:`repro_torch.train.step`), the deterministic
training-plant model that the training-loop binding
(:mod:`repro_torch.runtime.plant`) drives, and GPipe pipeline
parallelism over a mesh axis (:mod:`repro_torch.train.pipeline`, imported
from there as the reference's ``repro.train.pipeline`` is).

The pipeline runs its whole schedule as one autograd node: its backward
walks the ticks in reverse, and between two ticks every rank of the axis
sends its tick's input cotangent one stage up and receives the next
stage's (zeros from a bubble), the forward's hops in reverse order, so no
rank waits on a hop its partner's autograd pruned."""
from repro_torch.train.plant_model import make_stream_plant_model
from repro_torch.train.step import TrainStepConfig, build_train_step

__all__ = ["TrainStepConfig", "build_train_step",
           "make_stream_plant_model"]
