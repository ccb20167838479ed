"""Multi-device training over ``torch.distributed`` (counterpart of
``aat_tpu/parallel/``): one process per device (``distributed``), a mesh
of process groups with the JAX package's sharding rules (``mesh``), the
collectives with their gradients (``comm``) and Ulysses sequence-parallel
attention (``sequence``). The pipeline axis (``pp``) is ROADMAP Queue 1
item 8b."""
