from .sharding import REPLICA_AXIS, ReplicaMesh, put_global, replica_mesh, to_host

__all__ = ["REPLICA_AXIS", "ReplicaMesh", "put_global", "replica_mesh", "to_host"]
