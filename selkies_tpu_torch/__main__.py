"""``python -m selkies_tpu_torch`` → the port's orchestrator entrypoint."""

from selkies_tpu_torch.orchestrator import entrypoint

if __name__ == "__main__":
    entrypoint()
