"""Plan artifact, process mesh, launcher and training steps of the port."""
