"""Loops: one module a kind of traffic, named by a traffic file's `loop`,
driving the program's entry point through a window. Each holds a
`Cell(config, traffic, root, device, seed, seconds)` with `warm()`,
`window()`, `release()` and `check(control)`."""
