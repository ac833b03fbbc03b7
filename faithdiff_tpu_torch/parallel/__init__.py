"""Multi-GPU (counterpart of `faithdiff_tpu/parallel/`): process-group
start-up (`distributed`), ZeRO's sharding rule over the data axis (`mesh`),
and the UNet's tensor-parallel plan (`tp`)."""
