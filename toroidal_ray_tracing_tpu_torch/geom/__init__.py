"""Ray-primitive intersection math on tensors."""
