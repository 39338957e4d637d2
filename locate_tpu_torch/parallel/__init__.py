"""Data and tensor parallelism: process groups, the (data, model) mesh, the
step's backends, the model axis's layout and ZeRO."""
