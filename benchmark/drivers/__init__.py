"""Traffic generators, one module a traffic shape: a traffic file's
`driver` names the module, whose `Driver` sets the system up, runs the
measured window and checks the requests it sampled."""
