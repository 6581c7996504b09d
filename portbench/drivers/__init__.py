"""One module per traffic driver (``"driver"`` in a mix's file)."""
