"""Data parallelism: process groups, the mesh, the step's backends and ZeRO."""
