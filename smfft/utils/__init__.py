"""Cross-cutting utilities: ``compile_cache`` points JAX's persistent
compilation cache at one fixed directory for the entry-point scripts."""
