"""Data parallelism over processes, one per card (counterpart of
``pytorch_cifar_tpu/parallel/``): the rendezvous and the broadcasts in
``mesh``, the step's collectives in ``dp``."""
