"""Network compression (GENESIS building blocks), copied from the JAX
package as numpy."""
