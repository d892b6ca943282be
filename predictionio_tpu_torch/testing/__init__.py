"""Test helpers of the port that production code also reaches: the fake
clock and the fault-injection harness (trimmed copies of the JAX
package's ``testing/``)."""
