from .shots import MegabatchDriver, batch_generator, batch_seed, count_min_driver

__all__ = ["MegabatchDriver", "batch_generator", "batch_seed",
           "count_min_driver"]
