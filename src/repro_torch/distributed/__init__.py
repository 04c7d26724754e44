"""Where the sharded mapper's arrays live on a mesh (``sharding``)."""
