from .database import ExchangeDatabase, pool_box_flow

__all__ = ["ExchangeDatabase", "pool_box_flow"]
