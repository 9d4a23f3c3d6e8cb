"""utils layer of the celestia_tpu_torch port."""
