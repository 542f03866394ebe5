"""The multi-device slice: the reference's sharded BA, pose graph and BoW
query over `torch.distributed` process groups (`group`)."""
