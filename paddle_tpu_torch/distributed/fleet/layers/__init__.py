"""The port's paddle_tpu/distributed/fleet/layers: the tensor-parallel
``mpu`` ops and layers."""
