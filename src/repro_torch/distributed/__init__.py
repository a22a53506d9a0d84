from repro_torch.distributed.ctx import constrain, sharding_rules

__all__ = ["constrain", "sharding_rules"]
