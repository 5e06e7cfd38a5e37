"""Data and model parallelism: process groups (``mesh``), differentiable
collectives (``collectives``) and the within-level sharded forward and
train step (``sharded``). The data-parallel train step itself is
``train.step.make_train_step(..., group=)``."""
