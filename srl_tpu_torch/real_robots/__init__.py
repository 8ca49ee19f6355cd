"""The robot bridges (counterpart of srl_tpu/real_robots): the ZMQ
transport, the client envs of real robots, the Omnirobot simulator server,
the ROS-side servers, the marker finder and keyboard teleoperation. Host
code at robot speed; only the simulator server's env runs on the card."""
