"""Training of the port: optimizer, state, steps and the epoch program,
and the trainer (counterpart of ``pytorch_cifar_tpu/train/``)."""
