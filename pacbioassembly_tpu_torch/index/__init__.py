from .seedmap import SeedIndex, build_seedmap

__all__ = ["SeedIndex", "build_seedmap"]
