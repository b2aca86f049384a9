"""The paper's benchmark harnesses on the port."""
