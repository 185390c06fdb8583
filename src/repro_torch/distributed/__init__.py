"""Moving batches to the device."""
