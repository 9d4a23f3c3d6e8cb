"""parallel layer of the celestia_tpu_torch port: the sharded block extension over a mesh."""
