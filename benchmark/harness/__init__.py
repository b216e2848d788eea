"""What every cell shares: the manifest and the files found by name, the
measured window, spans, the profiler's reduction, the output check and the
guard against JAX."""
