"""Model definitions (``llama``) and the weight bridge from the JAX
package's numpy state dicts (``convert``)."""
