from .policy import MLP, ActorCritic, MAEFeatures  # noqa: F401
