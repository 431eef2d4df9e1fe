"""Fine-tuning: the sharded train step (loss, gradients, optimizer) over
the mesh (the reference's train/). Every rank holds its shards of the
parameters and the optimizer's moments; batches split over dp (and sp)."""

from .train import TrainState, cross_entropy_loss, make_train_step  # noqa: F401
