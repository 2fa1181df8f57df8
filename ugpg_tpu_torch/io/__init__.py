"""Weight bridge from JAX variable trees and reference-format checkpoints."""
