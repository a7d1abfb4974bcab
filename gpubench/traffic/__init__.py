"""The traffic mixes (JSON) and the generator of their inputs."""
