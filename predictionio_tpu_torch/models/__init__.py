"""Engine templates of the port. Ported so far: recommendation (ALS)
serving."""
