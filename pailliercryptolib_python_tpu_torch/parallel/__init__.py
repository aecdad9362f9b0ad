"""The sharded layer on ``torch.distributed``: counterpart of
``pailliercryptolib_python_tpu/parallel/``.

* ``distributed`` -- the process group's lifecycle from the
  ``PAILLIER_COORDINATOR`` / ``PAILLIER_NUM_PROCESSES`` /
  ``PAILLIER_PROCESS_ID`` contract (NCCL for a CUDA device, gloo for
  the CPU).
* ``mesh`` -- the ("dcn_host", "ici_chip") device mesh over the group's
  ranks and the batch layout: rank h*C + c owns the (h*C + c)-th block
  of B/n contiguous columns.
* ``collective`` -- the encrypted all-reduce (``sharded_he_sum``), the
  elementwise wrappers, and ``count_collectives``, the check that a
  shard's chain runs no collective.
* ``sharded_ops`` -- the CRT decrypt and ct*pt on a rank's own columns.
* ``entry`` -- the batched DJN encrypt step and a one-step federated
  dry run in a group of n ranks.

A sharded op on a CUDA tensor needs an NCCL group and on a CPU tensor a
gloo group; any other pairing raises.  Nothing moves work to the CPU.
"""
