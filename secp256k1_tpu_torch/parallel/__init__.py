"""Multi-device sharding on `torch.distributed`: one process per device."""
